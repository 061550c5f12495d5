"""The work one ``flash_attention`` forward launch needs, by the kernel
table's formula (PERF.md, section 6): for each of the B x Hq query heads,
q k^T and P v over the (q, k) pairs the mask lets through, 2 x 2 x hd
operations a pair, on the tensor cores in bfloat16; q, k, v read once and
the output written once. Bound by operations at prefill lengths."""

KERNEL_NAMES = ("flash_attention_wgmma_kernel",)


def pairs(s: int, window=None) -> int:
    """(q, k) pairs with 0 <= q - k < window (window None: q - k >= 0)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flops(b: int, hq: int, hkv: int, s: int, hd: int, window=None,
          dtype: str = "bfloat16") -> int:
    return 4 * b * hq * hd * pairs(s, window)


def bytes_moved(b: int, hq: int, hkv: int, s: int, hd: int, window=None,
                dtype: str = "bfloat16") -> int:
    size = {"bfloat16": 2, "float32": 4}[dtype]
    return size * b * s * hd * (2 * hq + 2 * hkv)
