"""Op-count analyzer of the port's steps; the counterpart of the reference's
HLO analyzer (``repro/analysis/hlo.py``).

The reference parses XLA's optimized HLO text. The port has no HLO: it runs
the step itself on ``meta`` tensors (shapes and dtypes, no data, no device)
under :class:`OpCounter`, a ``TorchDispatchMode`` that sees every aten op
eager PyTorch dispatches, forward and backward (autograd's own ops
included), and counts, with the reference's rules:

  * flops: products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
    ``dot``; ``matmul`` and ``einsum`` lower to these) by shape math, 2 per
    multiply-add, those on bf16/f16 operands also as ``tensor_core_flops``;
    elementwise ops 1 per output element; reductions 1 per input element;
  * transcendentals apart (exp, log, tanh, sigmoid, rsqrt, ...: each also
    1 flop);
  * HBM bytes: operand + result bytes of every op that computes or moves
    data (views and uninitialised allocations are free; a broadcast operand
    counts the elements it holds). On a card these are eager PyTorch's real,
    unfused traffic (every op reads its operands from device memory and
    writes its result), not a proxy after fusion as the reference's is;
  * collectives: none on one card. :func:`ring_link_bytes` keeps the
    reference's ring model, for a mesh of several devices;
  * op counts per aten op.

**Kernels are counted as the card runs them.** On meta, each kernel
wrapper of the model path (``flash_attention`` and its backward,
``lru_scan`` and its backward) allocates the outputs its kernel writes
(the LSE and scratch included) and reports the kernel's work with the
formulas of ``chip_smoke.py``'s bound through :func:`record_kernel`; it
launches nothing. That branch takes meta tensors only, so no real tensor
can reach it.

**Loops** whose body is the same each trip (the xLSTM's scans over time,
``nn.recurrent._scan``) go through :func:`unrolled`: under a counter it
runs two trips and counts the second ``n - 1`` times, as the reference's
analyzer multiplies a ``while`` body by its trip count. The autograd nodes
the second trip created run ``n - 1`` times in the backward, and so count
``n - 1`` times (a checkpointed region's recompute, which those nodes may
set off, counts once: no ``unrolled`` loop holds a checkpointed region
whole); what the first trip left alive past the second (saved
activations, collected outputs) stands for ``n - 1`` trips in the live
bytes.

**Peak bytes.** The counter also tracks the live bytes of the storages
born within it (allocations minus frees, watched through each storage's
finalizer, so a tensor autograd keeps for the backward stays counted until
the backward frees it) and their peak: with the step's arguments, the
step's peak device memory.
"""
from __future__ import annotations

import contextvars
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot"}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log10", "log1p", "expm1",
                   "rsqrt", "sqrt", "tanh", "sigmoid", "sin", "cos", "tan",
                   "erf", "erfc", "erfinv", "pow", "softplus", "gelu", "silu",
                   "log_sigmoid_forward", "log_sigmoid_backward",
                   "gelu_backward", "silu_backward", "softplus_backward",
                   "_softmax", "_log_softmax", "logit", "atan", "atan2"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "var", "std", "var_mean", "std_mean", "norm",
               "linalg_vector_norm", "prod", "cumsum", "cumprod",
               "logsumexp", "any", "all", "topk", "sort", "logcumsumexp"}
_FILLS = {"zeros", "ones", "full", "fill", "zero", "new_zeros", "new_ones",
          "new_full", "zeros_like", "ones_like", "full_like",
          "scalar_tensor", "arange", "linspace"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_local_scalar_dense", "set", "resize", "record_stream"}
_MOVERS = {"copy", "_to_copy", "clone", "cat", "stack", "index",
           "index_select", "gather", "scatter", "scatter_add",
           "scatter_reduce", "index_put", "index_add", "embedding",
           "embedding_dense_backward", "constant_pad_nd", "slice_backward",
           "select_backward", "slice_scatter", "select_scatter",
           "as_strided_scatter", "repeat", "flip", "roll", "_unsafe_index",
           "masked_scatter", "lift_fresh_copy", "expand_copy"}

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_op_counter", default=None)


def ring_link_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one device sends over its links for a collective of ``kind``
    ("all-reduce", "all-gather", "reduce-scatter", "all-to-all" or
    "collective-permute") whose result is ``out_bytes`` on each of ``n``
    devices in a ring: the reference's model. 0 on one device."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)          # operand = out * n
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}")


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _held_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` holds (a broadcast dimension, stride 0,
    holds one)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _host_scalar(t: torch.Tensor) -> bool:
    """A 0-d tensor on the host: the port keeps its step count there."""
    return t.device.type == "cpu" and t.dim() == 0


def _out_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args) -> float:
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if name in ("mm", "addmm"):
        a, b = ts[-2], ts[-1]
        flops = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        return flops + (a.shape[0] * b.shape[1] if name == "addmm" else 0)
    if name in ("bmm", "baddbmm", "addbmm"):
        a, b = ts[-2], ts[-1]
        flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        extra = a.shape[0] * a.shape[1] * b.shape[2] if name == "baddbmm" \
            else a.shape[1] * b.shape[2] if name == "addbmm" else 0
        return flops + extra
    if name in ("mv", "addmv"):
        a = ts[-2]
        return 2.0 * a.shape[0] * a.shape[1] \
            + (a.shape[0] if name == "addmv" else 0)
    return 2.0 * ts[0].numel()                               # dot


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _next_sequence_nr() -> int:
    """The sequence number the next autograd node will get (a probe node
    is made and dropped)."""
    t = torch.empty((), device="meta", requires_grad=True)
    return t.view(()).grad_fn._sequence_nr()


class OpCounter(TorchDispatchMode):
    """Counts what a step does on meta tensors (see the module docstring).
    Use as a context manager around the step; read :meth:`result` and
    ``peak_bytes`` after. Real tensors are refused."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.product_flops = 0.0
        self.tensor_core_flops = 0.0
        self.transcendentals = 0.0
        self.hbm_bytes = 0.0
        self.op_counts: Counter = Counter()
        self.kernels: Counter = Counter()
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        self._trips: list[int] = []
        self._births: list[set] = []
        # autograd node (by sequence number: holding the node would keep
        # its saved tensors) -> how many times it stands for (see unrolled)
        self._node_mult: dict[int, int] = {}
        self._quiet = False
        self._token = None

    # ------------------------------------------------------------ context
    def __enter__(self):
        self._token = _ACTIVE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.reset(self._token)

    def multiplier(self) -> float:
        m = 1.0
        for k in self._trips:
            m *= k
        node = torch._C._current_autograd_node()
        # a node runs with grad mode off; with it on, the node is unpacking
        # a checkpointed region's saved tensors and the ops are that
        # region's recompute, which runs once whatever the node stands for
        if node is not None and not torch.is_grad_enabled():
            m *= self._node_mult.get(node._sequence_nr(), 1)
        return m

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        real = [t for t in ins if not t.is_meta and not _host_scalar(t)]
        if real:
            raise ValueError(f"OpCounter counts meta tensors only; {func} "
                             f"got one on {real[0].device}")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._quiet or all(_host_scalar(t) for t in ins + outs):
            # host bookkeeping (the step count, the schedule) is no
            # device work
            return out
        name = func.overloadpacket.__name__
        base = name[:-1] if name.endswith("_") and not name.endswith("__") \
            else name
        in_keys = {_storage_key(t) for t in ins}
        view = func.is_view or (not func._schema.is_mutable and outs and all(
            _storage_key(t) in in_keys for t in outs))
        self._count(base, func, args, ins, outs, view)
        if not view:
            for t in outs:
                self._born(t, in_keys)
        return out

    def _count(self, base, func, args, ins, outs, view) -> None:
        mult = self.multiplier()
        self.op_counts[str(func.overloadpacket)] += mult
        if view or base in _FREE:
            return
        out_b = sum(_out_bytes(t) for t in outs)
        if base in _FILLS:
            self.hbm_bytes += mult * out_b
            return
        if base == "copy":                      # copy_(dst, src)
            self.hbm_bytes += mult * (_held_bytes(ins[1]) + out_b)
            return
        self.hbm_bytes += mult * (sum(_held_bytes(t) for t in ins) + out_b)
        out_n = sum(t.numel() for t in outs)
        if base in _MOVERS:
            return
        if base in _PRODUCTS:
            f = _product_flops(base, args)
            self.flops += mult * f
            self.product_flops += mult * f
            if ins[-1].dtype in (torch.bfloat16, torch.float16):
                self.tensor_core_flops += mult * f
            return
        if base in _REDUCTIONS:
            self.flops += mult * (ins[0].numel() if ins else out_n)
            return
        if base in _TRANSCENDENTAL:
            self.transcendentals += mult * out_n
        self.flops += mult * out_n

    # -------------------------------------------------------- live bytes
    def _born(self, t: torch.Tensor, in_keys) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in in_keys or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        for births in self._births:
            births.add(key)
        weakref.finalize(st, self._died, key)

    def _died(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)
        # the key (an address) may be reused by a later storage
        for births in self._births:
            births.discard(key)

    # ------------------------------------------------------------ kernels
    def record_kernel(self, name: str, *, flops: float, hbm_bytes: float,
                      tensor_core: bool, transcendentals: float = 0.0):
        mult = self.multiplier()
        self.kernels[name] += mult
        self.op_counts[f"kernel.{name}"] += mult
        self.flops += mult * flops
        self.kernel_flops += mult * flops
        if tensor_core:
            self.tensor_core_flops += mult * flops
        self.transcendentals += mult * transcendentals
        self.hbm_bytes += mult * hbm_bytes
        self.kernel_bytes += mult * hbm_bytes

    # -------------------------------------------------------------- loops
    def _unroll(self, n: int, body, carry):
        # a checkpointed region's recompute (in the backward) makes nodes
        # that never run: nothing to mark there
        grad = torch.is_grad_enabled() \
            and torch._C._current_autograd_node() is None
        if grad:
            self._quiet = True
            first = _next_sequence_nr()
            self._quiet = False
        self._births.append(set())
        carry, y0 = body(0, carry)
        born_first = self._births.pop()
        if grad:
            self._quiet = True
            lo = _next_sequence_nr()
            self._quiet = False
        self._trips.append(n - 1)
        try:
            carry, y1 = body(1, carry)
        finally:
            self._trips.pop()
        # what the first trip left alive past the second stands for the
        # n - 1 trips before the last
        for key in born_first & self._live.keys():
            extra = self._live[key] * (n - 2)
            self._live[key] += extra
            self.live_bytes += extra
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if grad:
            self._quiet = True
            hi = _next_sequence_nr()
            self._quiet = False
            self._mark_nodes(_tensors((carry, y1)), first, lo, hi, n - 1)
        return carry, [y0] + [y1] * (n - 1)

    def _mark_nodes(self, roots, first: int, lo: int, hi: int,
                    k: int) -> None:
        """Nodes created between sequence numbers lo and hi (the second
        trip) and reachable from its outputs: each runs k times. A
        gradient such a node passes to a node from before the loop (a
        weight, a tensor the loop reads every trip) is summed with the
        other trips' there: the two trips add once, and a hook on the node
        counts the other k - 1 additions."""
        stack = [t.grad_fn for t in roots if t.grad_fn is not None]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            seq = node._sequence_nr()
            if not lo <= seq < hi:
                continue
            self._node_mult[seq] = self._node_mult.get(seq, 1) * k
            shared = [i for i, (nxt, _) in enumerate(node.next_functions)
                      if nxt is not None
                      and not first <= nxt._sequence_nr() < hi]
            if shared:
                node.register_hook(self._summed(shared, k - 1))
            stack.extend(nxt for nxt, _ in node.next_functions)

    def _summed(self, edges, adds: int):
        def hook(grad_inputs, grad_outputs):
            for i in edges:
                g = grad_inputs[i]
                if g is not None:
                    self.op_counts["aten.add"] += adds
                    self.flops += adds * g.numel()
                    self.hbm_bytes += adds * 3 * _out_bytes(g)
        return hook

    # ------------------------------------------------------------- result
    def result(self) -> dict:
        """The reference ``analyze()``'s keys (``collectives`` empty and
        ``collective_link_bytes`` 0 on one card), the flops of the aten
        products (the reference's dots) and of those on tensor cores (the
        products and kernels in bf16), and the kernels' launches and
        share."""
        return {
            "flops": self.flops,
            "product_flops": self.product_flops,
            "tensor_core_flops": self.tensor_core_flops,
            "transcendentals": self.transcendentals,
            "hbm_bytes": self.hbm_bytes,
            "collective_link_bytes": 0.0,
            "collectives": {},
            "op_counts": dict(self.op_counts.most_common(30)),
            "kernels": dict(self.kernels),
            "kernel_flops": self.kernel_flops,
            "kernel_bytes": self.kernel_bytes,
        }


def record_kernel(name: str, **work) -> None:
    """Called by a kernel wrapper's meta branch: the kernel's work (see
    :meth:`OpCounter.record_kernel`) goes to the counter in effect; with
    none in effect the call only gave shapes, and nothing is recorded."""
    ctr = _ACTIVE.get()
    if ctr is not None:
        ctr.record_kernel(name, **work)


def unrolled(n: int, body, carry, *, stack: bool = False):
    """``carry, y = body(i, carry)`` for i in range(n); returns (carry, [y_0,
    ..., y_{n-1}]), or with ``stack`` (carry, the y stacked on a new
    leading axis). Under a counter, with n > 2, only two trips run and the
    second stands for the other n - 1 (the list repeats its y; the stack
    is one allocation of n rows, counted as reading n rows): see the
    module docstring. The body must do the same work on every trip."""
    ctr = _ACTIVE.get()
    if ctr is None or n <= 2:
        ys = []
        for i in range(n):
            carry, y = body(i, carry)
            ys.append(y)
        return carry, (torch.stack(ys) if stack else ys)
    carry, ys = ctr._unroll(n, body, carry)
    if not stack:
        return carry, ys
    y0, y1 = ys[0], ys[1]
    out = torch.cat([y0[None], y1[None].expand(n - 1, *y1.shape)])
    # the cat read y1 once; a stack reads each of the n - 1 rows
    ctr.hbm_bytes += (n - 2) * _out_bytes(y1)
    return carry, out


def analyze(fn, *args, **kwargs) -> tuple[dict, object]:
    """Run ``fn(*args, **kwargs)`` on meta tensors under a fresh
    :class:`OpCounter`: (the counts, fn's result). The counter's
    ``peak_bytes`` is in the counts as ``peak_bytes``: the most bytes
    allocated within the call and alive at once (the arguments are not
    included)."""
    with OpCounter() as ctr:
        out = fn(*args, **kwargs)
    res = ctr.result()
    res["peak_bytes"] = ctr.peak_bytes
    res["end_bytes"] = ctr.live_bytes
    return res, out
