"""The work one ``decode_attention`` launch needs (``csrc/decode_attention.cu``,
the kernel table's formula in PERF.md section 6): a decode step's
attention in one layer, for each of the B x Hq query heads q k^T and P v
over the L = min(s, window) positions it attends to, 2 x 2 x hd
operations a position; the keys and values at those positions read once
(per kv head, not per query head), q read and the output written once.
Bound by bytes at decode: G = hq / hkv operations a byte."""

KERNEL_NAMES = ("decode_attention_kernel",)


def _attended(s: int, window) -> int:
    return s if window is None else min(s, window)


def flops(b: int, hq: int, hkv: int, s: int, hd: int, window=None,
          dtype: str = "bfloat16") -> int:
    return 4 * b * hq * hd * _attended(s, window)


def bytes_moved(b: int, hq: int, hkv: int, s: int, hd: int, window=None,
                dtype: str = "bfloat16") -> int:
    size = {"bfloat16": 2, "float32": 4}[dtype]
    return size * b * hd * (2 * hkv * _attended(s, window) + 2 * hq)
