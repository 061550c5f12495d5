"""The work one ``wcc_round`` launch needs: the m int32 src and m int32 dst
ids read once, the n int32 input labels read once and the n output labels
written once; no arithmetic worth counting (a comparison and a min per
edge). Bound by bytes: 8m + 8n at the card's HBM bandwidth."""

KERNEL_NAMES = ("wcc_round_kernel",)


def bytes_moved(m: int, n: int) -> int:
    return 8 * m + 8 * n


def flops(m: int, n: int) -> int:
    return 0
