"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``):
the port and the JAX reference are fed the same NumPy inputs and their
outputs compared as host arrays."""
import numpy as np
import torch


def host(x) -> np.ndarray:
    """Host NumPy array of a torch tensor, a JAX array or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(got, want, what: str = "") -> None:
    """Byte identity: equal dtype, equal shape, equal bytes."""
    g, w = host(got), host(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert g.tobytes() == w.tobytes(), f"{what}: bytes differ"


def assert_views_same(port_view, ref_view, what: str = "") -> None:
    """A port JoinView is byte-identical to the reference's: the five CSR
    tensors and the host-side maintenance arrays."""
    assert port_view.version.pack() == ref_view.version.pack()
    assert port_view.n == ref_view.n and port_view.m == ref_view.m
    for f in ("offsets", "src", "dst", "out_degree", "in_degree",
              "np_keys", "np_src", "np_dst", "np_in_deg", "np_out_deg"):
        assert_same(getattr(port_view, f), getattr(ref_view, f),
                    f"{what} {f}")


def same_answer(got, want) -> bool:
    """Query answers equal: arrays byte-identical, tuples elementwise,
    scalars by ==."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(
            same_answer(a, b) for a, b in zip(got, want))
    if isinstance(want, np.ndarray):
        g = host(got)
        return (g.dtype == want.dtype and g.shape == want.shape
                and g.tobytes() == want.tobytes())
    return got == want
