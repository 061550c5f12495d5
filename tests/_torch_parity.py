"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``):
the port and the JAX reference are fed the same NumPy inputs and their
outputs compared as host arrays."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread in a test module that imports this fixture,
    and in the subprocesses it starts: the test workers share the
    machine's cores, and more threads a process only contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def load_chip_smoke():
    """``chip_smoke.py`` at the repository's root, imported as a module
    (its phases' functions rehearse on the CPU)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


# ------------------------------------------- the elastic and durable plane
def port_version(v):
    """The port's ``Version`` equal to a reference one (or to itself)."""
    from repro_torch.core.versioned import Version
    return Version(v.epoch, v.number)


def assert_batches_same(port_batches, ref_batches) -> None:
    """The two packages' generators made the same stream from one seed:
    equal versions, and every array field byte-identical."""
    assert len(port_batches) == len(ref_batches)
    for p, r in zip(port_batches, ref_batches):
        assert p.version.pack() == r.version.pack()
        for f in ("add_src", "add_dst", "del_src", "del_dst",
                  "add_vertices", "vertex_types"):
            assert_same(getattr(p, f), getattr(r, f),
                        f"{r.version} {f}")


def both_streams(name: str, *args, **kw):
    """(port batches, reference batches) of the generator ``name`` of
    ``graph/dyngraph.py`` for one seed, checked equal."""
    from repro.graph import dyngraph as rdg
    from repro_torch.graph import dyngraph as tdg
    port = getattr(tdg, name)(*args, **kw)
    ref = getattr(rdg, name)(*args, **kw)
    assert_batches_same(port, ref)
    return port, ref


def assert_stores_same(port_store, ref_store, epochs, loop=None) -> None:
    """Two stores (the port's and the reference's) stitch byte-identical
    join views at every epoch in ``epochs`` (each at number 0), and, with
    ``loop`` (a reference ``LoopDynamicGraph``), equal to the loop
    oracle's CSR arrays too."""
    from repro.core.versioned import Version as RV
    for e in epochs:
        rv = RV(e, 0)
        pv = port_store.join_view(port_version(rv))
        assert_views_same(pv, ref_store.join_view(rv), f"epoch {e}")
        if loop is not None:
            # the loop oracle's arrays are int64: equal values (dtypes are
            # held by the comparison with the reference store above)
            for got, want in zip(
                    (pv.offsets, pv.src, pv.dst, pv.np_out_deg,
                     pv.np_in_deg), loop.join_view_arrays(rv)):
                assert np.array_equal(host(got), want), f"epoch {e} loop"


def port_query(q):
    """The port's query dataclass equal to a reference query."""
    from repro_torch.graph import query as tq
    return getattr(tq, type(q).__name__)(**q.__dict__)


# the port's architectures that the reference does not have
PORT_ONLY_ARCHS = ("deepseek-v2-lite",)


def reference_archs() -> list[str]:
    """The port's registry less its own architectures: the reference's
    ten, without importing the reference."""
    from repro_torch.configs import all_configs

    return sorted(set(all_configs()) - set(PORT_ONLY_ARCHS))


def assert_config_same(cfg, ref_cfg) -> None:
    """The port's config is the reference's: every field the reference's
    has is equal, and every field only the port's has (latent attention
    and DeepSeekMoE) is at its default."""
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    assert {k: got.get(k) for k in want} == want
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    assert {k: v for k, v in got.items() if k not in want} == \
        {k: defaults[k] for k in got if k not in want}

