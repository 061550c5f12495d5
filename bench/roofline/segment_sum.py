"""The work one ``segment_sum`` launch needs: (m, F) float32 values and m
int32 segment ids read once, (n, F) float32 sums written once, one add per
value. At the PageRank shape (F = 1) it is bound by bytes: m * (4F + 4) +
n * 4F at the card's HBM bandwidth."""

KERNEL_NAMES = ("segment_sum_f1_kernel", "segment_sum_rows_kernel")


def bytes_moved(m: int, n: int, f: int = 1, dtype: str = "float32") -> int:
    value_bytes = {"float32": 4, "bfloat16": 2}[dtype]
    return m * (value_bytes * f + 4) + n * 4 * f


def flops(m: int, n: int, f: int = 1, dtype: str = "float32") -> int:
    return m * f
