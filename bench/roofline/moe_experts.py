"""The work one grouped expert product of the dropless MoE dispatch
needs (``nn/moe.py``: three a layer and group of tokens, ``w1`` and
``w3`` of (D, F) and ``w2`` of (F, D) for each expert, 6 D F operations a
routed slot over the three): 2 D F operations a slot on the tensor cores
in bfloat16; the weights of the experts the group's slots touch read once
(``experts``: every expert, for a prefill group's 196,608 slots) and each
slot's row in (D or F) and out (F or D) once. A decode step's few tokens
take batched products over every expert instead (``nn/moe.py``), which
this count does not cover."""

KERNEL_NAMES = ("GroupProblemShape",)


def flops(slots: int, d: int, f: int, experts: float,
          dtype: str = "bfloat16") -> float:
    return 2.0 * slots * d * f


def bytes_moved(slots: int, d: int, f: int, experts: float,
                dtype: str = "bfloat16") -> float:
    size = {"bfloat16": 2, "float32": 4}[dtype]
    return size * (experts * d * f + slots * (d + f))
