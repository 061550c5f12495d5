"""Faults to plant in the program under a generation cell, each a context
manager that patches the port while it is open: what the cell's check
(``generate.numbers``) has to catch. The CPU tests plant each one and see
``correct`` come out false; ``calibrate.py --faults`` reads them on the
card at the cell's own size.

On the CPU the prefill's attention takes the plain route, which never
calls ``ops.flash_attention``; :func:`kernel_route_stand_in` sends it
through ``ops.flash_attention`` with the kernel's plain version
(``kernels/ref.py``) in the kernel's place, so that the attention faults,
planted at the kernel's entry as on the card, reach it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name: str, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def kernel_route_stand_in():
    """The prefill's attention through ``ops.flash_attention`` on any
    device, the plain ``ref.flash_attention`` standing in for the CUDA
    kernel."""
    from repro_torch.kernels import ops, ref

    def attend(q, k, v, *, causal=True, window=None, use_kernel=None):
        return ref.flash_attention(q, k, v, causal=causal, window=window)

    with _patched(ops, "wants_kernel", lambda t, use_kernel: True), \
            _patched(ops, "flash_attention", attend):
        yield


def _attention_args(alter):
    """``ops.flash_attention``, the prefill's attention, with its
    arguments altered by ``alter(q, k, v, kw)``."""
    from repro_torch.kernels import ops

    real = ops.flash_attention

    def faulty(q, k, v, **kw):
        q, k, v, kw = alter(q, k, v, kw)
        return real(q, k, v, **kw)

    return _patched(ops, "flash_attention", faulty)


def causal_off():
    """The prefill's attention with the causal mask off."""
    return _attention_args(lambda q, k, v, kw: (q, k, v,
                                                {**kw, "causal": False}))


def kv_heads_rolled():
    """The prefill's kv heads rolled by one: each group of query heads
    reads its neighbour's keys and values."""
    return _attention_args(lambda q, k, v, kw: (q, k.roll(1, 1),
                                                v.roll(1, 1), kw))


@contextlib.contextmanager
def layer_skipped():
    """The middle layer's output left out, in the prefill and in every
    decode step (its cache is still filled)."""
    from repro_torch.models import transformer as tf

    order: dict[int, int] = {}
    apply, decode = tf.apply_block, tf._decode_block

    def skipped(p, cfg) -> bool:
        return order.setdefault(id(p), len(order)) == cfg.num_layers // 2

    def apply_block(p, x, cfg, kind, *args, **kw):
        y, cache, aux = apply(p, x, cfg, kind, *args, **kw)
        return (x if skipped(p, cfg) else y), cache, aux

    def decode_block(p, c, x, cfg, kind, pos):
        y, c = decode(p, c, x, cfg, kind, pos)
        return (x if skipped(p, cfg) else y), c

    with _patched(tf, "apply_block", apply_block), \
            _patched(tf, "_decode_block", decode_block):
        yield


def qkv_bias_left_out():
    """The attention's q, k and v projections without their biases."""
    from repro_torch.nn import attention as attn

    real = attn.dense
    return _patched(attn, "dense", lambda x, w, b=None: real(x, w))


def state_unchanged():
    """A decode step that leaves its state as it found it: the step's key
    and value are never written into the cache."""
    from repro_torch.nn import attention as attn

    real = attn.attn_decode

    def attn_decode(p, x, cfg, kind, cache, pos):
        k = cache["k"][:, :, pos].clone()
        v = cache["v"][:, :, pos].clone()
        y, cache = real(p, x, cfg, kind, cache, pos)
        cache["k"][:, :, pos] = k
        cache["v"][:, :, pos] = v
        return y, cache

    return _patched(attn, "attn_decode", attn_decode)


def half_batch():
    """The prefill run on the first half of the batch, its logits and
    caches standing for the second half too."""
    from repro_torch.models import transformer as tf

    real = tf.prefill

    def tree(x, fn):
        if isinstance(x, dict):
            return {k: tree(v, fn) for k, v in x.items()}
        if isinstance(x, list):
            return [tree(v, fn) for v in x]
        return fn(x)

    def prefill(model, cfg, inputs, capacity=None, use_kernel=None):
        B = inputs.shape[0]
        logits, cache = real(model, cfg, inputs[:B // 2], capacity,
                             use_kernel)

        def full(t):
            return torch.cat([t, t[:B - B // 2]])

        return full(logits), tree(cache, full)

    return _patched(tf, "prefill", prefill)


def token_altered():
    """One served token of every sequence altered where the server hands
    the tokens out: the middle step's id plus one."""
    from repro_torch.launch.serve import Server

    real = Server.generate

    def generate(self, prompts, max_new, **kw):
        out = real(self, prompts, max_new, **kw)
        out[:, max_new // 2] = (out[:, max_new // 2] + 1) \
            % self.cfg.vocab_size
        return out

    return _patched(Server, "generate", generate)


FAULTS = {"causal_off": causal_off, "kv_heads_rolled": kv_heads_rolled,
          "layer_skipped": layer_skipped,
          "qkv_bias_left_out": qkv_bias_left_out,
          "state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
