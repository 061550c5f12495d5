"""The work one launch of the latent attention's prefill kernel needs,
counted on the attention's own dims, not the kernel's padded ones: for
each of the b x h heads, q k^T over dqk (qk_nope + qk_rope) and P v over
dv a causal (q, k) pair, 2 operations each, on the tensor cores in
bfloat16; q and k (dqk) and v (dv) read once and the output (dv) written
once. The program runs it on the ``wgmma`` flash-attention kernel with
q, k and v zero-padded to 256 (``nn/mla.py``); the padding is not work."""

KERNEL_NAMES = ("flash_attention_wgmma_kernel",)


def flops(b: int, h: int, s: int, dqk: int, dv: int,
          dtype: str = "bfloat16") -> int:
    return 2 * (dqk + dv) * b * h * (s * (s + 1) // 2)


def bytes_moved(b: int, h: int, s: int, dqk: int, dv: int,
                dtype: str = "bfloat16") -> int:
    size = {"bfloat16": 2, "float32": 4}[dtype]
    return size * b * h * s * (2 * dqk + 2 * dv)
