"""The offline generation cells: batches of prompts through the model
server's ``Server.generate``, one call after another.

Set-up draws the configuration's weights from the seed on the card
(``model_weights.py``) into the port's model, builds ``launch.serve.Server``
over it (``program.model_server``) and runs one short call untimed: a
call's whole prefill and ``WARM_STEPS`` decode steps. Nothing in a call
compiles, and its decode steps differ from these only in the cache's
capacity (prompt plus output tokens), which every step attends over.
In the window, call after call (a closed loop of offline batches):
``batch`` prompts of ``prompt_len`` token ids drawn uniformly from the
vocabulary from (seed, call), ``gen`` greedy tokens each. A call that
started inside the window and ended after it is run to its end and not
counted.

For the check, a wrapper around the server's decode step keeps on the
card, on every call alike, the logits rows of ``checked_rows`` of the
batch's sequences at every step: one from each equal share of the batch,
drawn from the seed. The last call that finished inside the window is
held against the plain reference (``model_reference.py``), teacher-forced
over its prompts and served tokens (:func:`numbers`).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchlib import model_reference, program

CONTROL_BITS = 4        # significant bits of fp8 e4m3, below bfloat16's 8
WARM_STEPS = 4


def checked_rows(seed: int, batch: int, n: int) -> list[int]:
    """One row from each of ``n`` equal shares of the batch."""
    rng = np.random.default_rng([seed % 2**64, 1])
    share = batch // n
    return [k * share + int(rng.integers(share)) for k in range(n)]


def prompts(seed: int, call: int, batch: int, prompt_len: int,
            vocab: int) -> np.ndarray:
    rng = np.random.default_rng([seed % 2**64, 2, call])
    return rng.integers(0, vocab, (batch, prompt_len), dtype=np.int32)


class Recorder:
    """Stands for the server's decode step: calls it, then copies the
    checked rows' logits of the step into ``buffers[slot]`` (gen, one row
    a step). With a trace window open, it closes the window after
    ``trace_steps`` decode steps."""

    def __init__(self, server, rows, prompt_len: int, gen: int, vocab: int,
                 device, trace_window=None, trace_steps: int = 0):
        self.inner = server.decode
        self.rows = torch.tensor(rows, device=device)
        self.prompt_len = prompt_len
        self.buffers = [torch.empty((len(rows), gen, vocab),
                                    dtype=torch.float32, device=device)
                        for _ in range(2)]
        self.slot = 0
        self.trace, self.trace_steps = trace_window, trace_steps
        server.decode = self

    def __call__(self, model, cache, inputs, pos: int):
        logits, cache = self.inner(model, cache, inputs, pos)
        step = pos - self.prompt_len
        self.buffers[self.slot][:, step] = logits[self.rows, 0]
        tw = self.trace
        if tw is not None and tw.t0 is not None and tw.t1 is None \
                and step + 1 >= self.trace_steps:
            tw.stop()
        return logits, cache


def run_cell(run, device, t_proc: float, trace_window=None) -> dict:
    cfg, tr = run.config, run.traffic
    B, P, gen = tr["batch"], tr["prompt_len"], tr["gen"]
    vocab = cfg["vocab_size"]
    server = program.model_server(cfg, run.seed, device)
    mcfg = server.cfg
    rows = checked_rows(run.seed, B, tr["checked_rows"])
    rec = Recorder(server, rows, P, gen, vocab, device, trace_window,
                   tr["trace_decode_steps"])
    server.generate(prompts(run.seed, 0, B, P, vocab), WARM_STEPS)
    attn_shape = {"b": B, "hq": mcfg.n_heads, "hkv": mcfg.n_kv_heads,
                  "s": P, "hd": mcfg.resolved_head_dim,
                  "dtype": cfg["torch_dtype"]}
    run.t_open = time.monotonic()
    run.t_close = run.t_open + run.seconds
    run.setup_s = run.t_open - t_proc
    calls = []
    call, traced = 1, 0
    while time.monotonic() < run.t_close:
        if trace_window is not None and trace_window.t0 is None and \
                time.monotonic() >= run.t_open + tr["trace_offset_s"]:
            trace_window.start()
            traced = call
        x = prompts(run.seed, call, B, P, vocab)
        rec.slot = call % 2
        s = time.monotonic()
        out = server.generate(x, gen)
        e = time.monotonic()
        tm = server.timings
        ok = out.shape == (B, gen) and out.dtype == np.int32 \
            and bool(((out >= 0) & (out < vocab)).all())
        calls.append({"end": e, "prompts": x, "out": out, "slot": rec.slot,
                      "ok": ok, "split": (round(tm["prefill_s"], 4),
                                          round(tm["decode_s"], 4),
                                          round(e - run.t_open, 3))})
        run.spans += [("generate", s, e,
                       {"call": call, "batch": B, "prompt": P, "gen": gen,
                        "tokens": B * gen, "prefill_s": tm["prefill_s"],
                        "decode_s": tm["decode_s"],
                        "traced": call == traced}),
                      ("prefill", s, s + tm["prefill_s"], {"call": call}),
                      ("decode", e - tm["decode_s"], e, {"call": call})]
        run.kernel_calls.append((s, s + tm["prefill_s"], "flash_attention",
                                 mcfg.num_layers, attn_shape))
        if trace_window is not None and trace_window.t0 is not None \
                and trace_window.t1 is None:
            trace_window.stop()
        call += 1
    print("calls (prefill s, decode s, end from the open s): "
          f"{[c['split'] for c in calls]}", file=sys.stderr, flush=True)
    inside = [c for c in calls if c["end"] <= run.t_close]
    checked = (inside or calls)[-1]
    run.attempted = len(calls)
    run.failed = sum(not c["ok"] for c in calls)
    idx = torch.tensor(rows, device=device)
    state = {"checked": {
        "prompts": torch.as_tensor(checked["prompts"], device=device)[idx]
        .long(),
        "out": torch.as_tensor(checked["out"], device=device)[idx].long(),
        "logits": rec.buffers[checked["slot"]]},
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if device.type == "cuda" else 0)}
    rec.buffers = rec.inner = server.decode = None
    del server, rec
    return state


def numbers(run, state: dict, config: dict, control: bool) -> dict:
    """The generation cell's compared numbers, on its checked call's
    sequences: ``logits_rel``, the worst over the decode steps' logits
    rows of the largest gap to the reference's row over the row's largest
    magnitude; ``token_gap``, the widest gap by which a served token's
    reference logit lies below the reference's best at its position;
    ``malformed_calls``, calls whose tokens were not (batch, gen) int32 ids
    of the vocabulary. With ``control`` the reference rounded to
    ``CONTROL_BITS`` takes the program's place: its logits, and at each
    position the token it puts first."""
    chk = state["checked"]
    P = chk["prompts"].shape[1]
    tokens = torch.cat([chk["prompts"], chk["out"]], dim=1)
    ref = model_reference.logits(config, run.seed, tokens, P - 1)
    if control:
        low = model_reference.logits(config, run.seed, tokens, P - 1,
                                     bits=CONTROL_BITS)
        got, served = low[:, 1:], low[:, :-1].argmax(-1)
        del low
    else:
        got, served = chk["logits"], chk["out"]
    want = ref[:, 1:]
    rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max()
    at = ref[:, :-1].gather(-1, served[..., None])[..., 0]
    gap = (ref[:, :-1].amax(-1) - at).max()
    return {"logits_rel": float(rel), "token_gap": float(gap),
            "malformed_calls": run.failed}
