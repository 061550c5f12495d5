"""The offline generation cells of a DeepSeek-V2 configuration: batches
of prompts through the model server's ``Server.generate``, one call after
another, as ``generate.py`` runs a dense decoder's.

The loop is ``generate.py``'s, with its ``prompts``, ``checked_rows`` and
``Recorder`` (here extended), over a server whose weights
``deepseek_v2_weights.py`` draws from the seed. Besides the checked rows'
logits, the run keeps on the card, on every call alike:

* the checked rows' expert ids at every MoE layer and position (the
  program's route hook, ``nn.moe.install_route_hook``), which the plain
  reference replays (``deepseek_v2_reference.py``);
* the checked rows' latent cache at the positions the decode steps wrote,
  every layer, as the call's last step leaves it;
* each MoE layer's expert-load counter (``MoE.load``), zeroed before each
  call and copied on the card at the call's first decode step, so that
  the copy holds the prefill's slots per expert; the traced call's copy
  is read after it, as ``run.counters["moe_prefill_load"]``;
* in the traced call only, the experts each decode step's tokens touch in
  every MoE layer (the route hook again), read after the call as their
  mean count a step and layer, ``run.counters["moe_decode_touched"]``,
  which the decode's byte bound (``roofline/mla_decode_step.py``) reads.

For the traced call it records in ``run.kernel_calls`` the prefill's
launches that the roofline counts read: the latent attention's
flash-attention launches (``mla_prefill``) and the three grouped expert
products of every MoE layer and group of tokens (``moe_experts``; a
group's 196,608 slots reach every expert). After the trace it counts the
host syncs (``aten::_local_scalar_dense``, ``cudaStreamSynchronize``)
that fall inside the program's ``Model.moe`` and ``Model.mla`` spans, as
a note of the run.

The last call that finished inside the window is held against the plain
reference (:func:`numbers`).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchlib import deepseek_v2_reference, deepseek_v2_weights
from benchlib.generate import (CONTROL_BITS, WARM_STEPS, Recorder,
                               checked_rows, prompts)

SYNC_EVENTS = ("aten::_local_scalar_dense", "cudaStreamSynchronize",
               "cudaDeviceSynchronize")
MODEL_SPANS = ("Model.moe", "Model.mla")


def model_config(config: dict):
    """The port's ``ModelConfig`` of a DeepSeek-V2 configuration: the
    architecture ``config["arch"]`` at the configuration's sizes. Raises
    where the port's architecture is not the model the configuration and
    its reference describe."""
    import dataclasses

    from repro_torch.configs import YaRN, get_config

    s = deepseek_v2_weights.shape_of(config)
    y = config["rope_scaling"]
    cfg = dataclasses.replace(
        get_config(config["arch"]), num_layers=s["layers"], d_model=s["d"],
        n_heads=s["h"], n_kv_heads=s["h"], head_dim=s["v"], d_ff=s["ff"],
        vocab_size=s["vocab"], n_experts=s["e"], top_k=s["k"],
        d_ff_expert=s["ffe"], kv_lora_rank=s["r"],
        qk_nope_head_dim=s["nope"], qk_rope_head_dim=s["rope"],
        v_head_dim=s["v"], n_shared_experts=s["shared"],
        first_k_dense=s["dense"], norm_topk_prob=config["norm_topk_prob"],
        rope_theta=float(config["rope_theta"]),
        rope_scaling=YaRN(factor=float(y["factor"]),
                          original_max_position=int(
                              y["original_max_position_embeddings"]),
                          beta_fast=float(y["beta_fast"]),
                          beta_slow=float(y["beta_slow"]),
                          mscale=float(y["mscale"]),
                          mscale_all_dim=float(y["mscale_all_dim"])))
    want = {"pattern": ("mla",), "ffn": "moe", "moe_impl": "dropless",
            "norm": "rms", "embed_mode": "tokens", "tie_embeddings": False,
            "scale_embeddings": False, "sandwich_norm": False,
            "logit_softcap": 0.0}
    got = {k: getattr(cfg, k) for k in want}
    got["pattern"] = tuple(got["pattern"])
    if got != want or config["tie_word_embeddings"] \
            or config["rms_norm_eps"] != 1e-6 \
            or config["routed_scaling_factor"] != 1 \
            or config["rope_scaling"]["type"] != "yarn" \
            or config["q_lora_rank"] is not None:
        raise ValueError(f"{config['arch']} is not the configuration's "
                         f"model: {got} != {want}")
    return cfg


def model_server(config: dict, seed: int, device):
    """``launch.serve.Server`` over the port's model holding the weights
    ``deepseek_v2_weights`` draws from ``seed``, after
    ``nn.layers.strict_matmul()``."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.transformer import Transformer
    from repro_torch.nn.layers import strict_matmul

    cfg = model_config(config)
    strict_matmul()
    model = Transformer(cfg, device)
    named = dict(model.named_parameters())
    specs = deepseek_v2_weights.specs(config)
    if sorted(named) != sorted(name for name, _, _ in specs):
        raise ValueError("the port's parameters are not the drawn ones: "
                         f"{sorted(set(named) ^ {n for n, _, _ in specs})}")
    with torch.no_grad():
        for name, shape, kind in specs:
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name}: the port holds "
                                 f"{tuple(named[name].shape)}, not {shape}")
            named[name].copy_(deepseek_v2_weights.draw(config, seed, name,
                                                       shape, kind, device))
    return Server(cfg, model)


class Routes:
    """The route hook: keeps the checked rows' expert ids of every MoE
    layer and position in ``buffers[slot]`` (MoE layers, rows, positions,
    top_k), uint8, on the card. ``pos`` is the position of the call's
    first token (0 for a prefill, a decode step's own)."""

    def __init__(self, rows, layers: int, first: int, positions: int,
                 k: int, device):
        self.rows = torch.tensor(rows, device=device)
        self.first = first
        self.buffers = [torch.zeros((layers, len(rows), positions, k),
                                    dtype=torch.uint8, device=device)
                        for _ in range(2)]
        self.slot, self.pos = 0, 0
        self.touched, self.prompt = None, 0

    def count_touched(self, prompt: int, steps: int, experts: int) -> None:
        """From the next call on, marks in ``touched`` (steps, MoE layers,
        experts) the experts the tokens of each decode step after a
        prompt of ``prompt`` touch, until ``touched`` is set to None."""
        self.prompt = prompt
        self.touched = torch.zeros(
            (steps, self.buffers[0].shape[0], experts), dtype=torch.bool,
            device=self.rows.device)

    def __call__(self, layer: int, ids: torch.Tensor) -> None:
        S = ids.shape[1]
        self.buffers[self.slot][layer - self.first, :,
                                self.pos:self.pos + S] = \
            ids.index_select(0, self.rows).to(torch.uint8)
        if self.touched is not None and S == 1:
            self.touched[self.pos - self.prompt, layer - self.first] \
                .index_fill_(0, ids.reshape(-1), True)


class MLARecorder(Recorder):
    """``generate.Recorder`` that also tells the route hook each decode
    step's position, copies the MoE layers' load counters at the call's
    first step (the prefill's), and copies the checked rows' latent cache
    at the decode positions after a whole call's last step into
    ``latents[slot]``."""

    def __init__(self, server, rows, prompt_len, gen, vocab, device, routes,
                 moes, trace_window=None, trace_steps=0):
        super().__init__(server, rows, prompt_len, gen, vocab, device,
                         trace_window, trace_steps)
        self.cfg, self.gen = server.cfg, gen
        self.routes, self.moes = routes, moes
        self.latents = [None, None]
        self.prefill_load = None

    def __call__(self, model, cache, inputs, pos: int):
        from repro_torch.models.transformer import layer_caches

        P = self.prompt_len
        if pos == P:
            self.prefill_load = torch.stack([m.load for m in self.moes])
        self.routes.pos = pos
        logits, cache = super().__call__(model, cache, inputs, pos)
        if pos == P + self.gen - 1:
            self.latents[self.slot] = torch.stack(
                [c["latent"].index_select(0, self.rows)[:, P:P + self.gen]
                 for c in layer_caches(self.cfg, cache)])
        return logits, cache


def _syncs_in_spans(prof) -> dict:
    """Host syncs inside the program's model spans, from a finished
    profiler session's host events."""
    events = list(prof.events())
    spans = [(e.thread, e.time_range.start, e.time_range.end)
             for e in events if e.name in MODEL_SPANS]
    inside = 0
    for e in events:
        if e.name in SYNC_EVENTS:
            t = e.time_range.start
            inside += any(th == e.thread and a <= t <= b
                          for th, a, b in spans)
    return {"model_spans": len(spans), "syncs_in_model_spans": inside}


def run_cell(run, device, t_proc: float, trace_window=None) -> dict:
    from repro_torch.nn import mla, moe

    cfg, tr = run.config, run.traffic
    B, P, gen = tr["batch"], tr["prompt_len"], tr["gen"]
    vocab = cfg["vocab_size"]
    server = model_server(cfg, run.seed, device)
    s = deepseek_v2_weights.shape_of(cfg)
    moes = [m for m in server.params.modules() if isinstance(m, moe.MoE)]
    rows = checked_rows(run.seed, B, tr["checked_rows"])
    routes = Routes(rows, len(moes), s["dense"], P + gen, s["k"], device)
    moe.install_route_hook(server.params, routes)
    rec = MLARecorder(server, rows, P, gen, vocab, device, routes, moes,
                      trace_window, tr["trace_decode_steps"])
    routes.pos = 0
    # the warm call marks touched experts too, so that their kernel is
    # loaded before the traced call
    routes.count_touched(P, WARM_STEPS, s["e"])
    server.generate(prompts(run.seed, 0, B, P, vocab), WARM_STEPS)
    routes.touched = None
    seqs = max(1, mla.PREFILL_TOKENS // P)
    mla_launches = {}
    for lo in range(0, B, seqs):
        b = min(B, lo + seqs) - lo
        mla_launches[b] = mla_launches.get(b, 0) + s["layers"]
    run.t_open = time.monotonic()
    run.t_close = run.t_open + run.seconds
    run.setup_s = run.t_open - t_proc
    calls = []
    call, traced, syncs = 1, 0, None
    while time.monotonic() < run.t_close:
        tracing = False
        if trace_window is not None and trace_window.t0 is None and \
                time.monotonic() >= run.t_open + tr["trace_offset_s"]:
            trace_window.start()
            traced, tracing = call, True
        x = prompts(run.seed, call, B, P, vocab)
        rec.slot = routes.slot = call % 2
        routes.pos = 0
        for m in moes:
            m.load.zero_()
        if tracing:
            routes.count_touched(P, gen, s["e"])
        s0 = time.monotonic()
        out = server.generate(x, gen)
        e = time.monotonic()
        tm = server.timings
        ok = out.shape == (B, gen) and out.dtype == np.int32 \
            and bool(((out >= 0) & (out < vocab)).all())
        calls.append({"end": e, "prompts": x, "out": out, "slot": rec.slot,
                      "ok": ok, "split": (round(tm["prefill_s"], 4),
                                          round(tm["decode_s"], 4),
                                          round(e - run.t_open, 3))})
        run.spans += [("generate", s0, e,
                       {"call": call, "batch": B, "prompt": P, "gen": gen,
                        "tokens": B * gen, "prefill_s": tm["prefill_s"],
                        "decode_s": tm["decode_s"],
                        "traced": call == traced}),
                      ("prefill", s0, s0 + tm["prefill_s"], {"call": call}),
                      ("decode", e - tm["decode_s"], e, {"call": call})]
        if tracing:
            if trace_window.t1 is None:
                trace_window.stop()
            _traced_prefill(run, s, B, P, s0, s0 + tm["prefill_s"],
                            mla_launches, moe.DROPLESS_TOKENS, len(moes))
            run.counters["moe_prefill_load"] = rec.prefill_load.tolist()
            run.counters["moe_decode_touched"] = float(
                routes.touched.sum(-1).double().mean())
            routes.touched = None
            syncs = _syncs_in_spans(trace_window.prof)
        call += 1
    print("calls (prefill s, decode s, end from the open s): "
          f"{[c['split'] for c in calls]}", file=sys.stderr, flush=True)
    if syncs is not None:
        run.notes.append(syncs)
        print(f"host syncs in the traced window: {syncs}", file=sys.stderr,
              flush=True)
    inside = [c for c in calls if c["end"] <= run.t_close]
    checked = (inside or calls)[-1]
    run.attempted = len(calls)
    run.failed = sum(not c["ok"] for c in calls)
    idx = torch.tensor(rows, device=device)
    state = {"checked": {
        "prompts": torch.as_tensor(checked["prompts"], device=device)[idx]
        .long(),
        "out": torch.as_tensor(checked["out"], device=device)[idx].long(),
        "logits": rec.buffers[checked["slot"]],
        "routes": routes.buffers[checked["slot"]],
        "latent": rec.latents[checked["slot"]]},
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if device.type == "cuda" else 0)}
    moe.install_route_hook(server.params, None)
    rec.buffers = rec.latents = rec.inner = server.decode = None
    del server, rec, routes, moes
    return state


def _traced_prefill(run, s: dict, B: int, P: int, s0: float, s1: float,
                    mla_launches: dict, group: int, moe_layers: int) -> None:
    """The traced prefill's kernel calls: the latent attention's
    flash-attention launches, and the grouped expert products of each MoE
    layer and group of tokens."""
    dtype = run.config["torch_dtype"]
    for b, n in mla_launches.items():
        run.kernel_calls.append((s0, s1, "mla_prefill", n, {
            "b": b, "h": s["h"], "s": P, "dqk": s["nope"] + s["rope"],
            "dv": s["v"], "dtype": dtype}))
    for lo in range(0, B * P, group):
        run.kernel_calls.append((s0, s1, "moe_experts", 3 * moe_layers, {
            "slots": min(group, B * P - lo) * s["k"], "d": s["d"],
            "f": s["ffe"], "experts": s["e"], "dtype": dtype}))


def numbers(run, state: dict, config: dict, control: bool) -> dict:
    """``generate.numbers``' three on the checked call's sequences; the
    routing's two, ``route_flip_share`` and ``route_flip_gap`` of the
    program's expert ids against the reference's own routing; and
    ``latent_cache_rel``: over every layer and decode position of the
    checked rows, the largest gap of the program's latent cache row
    (the normed latent and the rotated k_pe) to the reference's, over
    the reference row's largest magnitude. With ``control`` the reference
    rounded to ``CONTROL_BITS``, routing itself, takes the program's
    place: its logits, the token it puts first at each position, its
    expert ids and its latents, against the reference replaying those
    ids."""
    chk = state["checked"]
    P = chk["prompts"].shape[1]
    tokens = torch.cat([chk["prompts"], chk["out"]], dim=1)
    routes = chk["routes"]
    if control:
        low = deepseek_v2_reference.run(config, run.seed, tokens, P - 1,
                                        bits=CONTROL_BITS)
        routes, latent = low["routes"], low["latent"]
        got, served = low["logits"][:, 1:], low["logits"][:, :-1].argmax(-1)
        del low
    else:
        got, served = chk["logits"], chk["out"]
        r = config["kv_lora_rank"]
        lat = chk["latent"].float()
        # the program keeps k_pe's rotated pairs in place; the reference
        # gathers the even entries before the odd ones
        latent = torch.cat([lat[..., :r], lat[..., r::2], lat[..., r + 1::2]],
                           dim=-1)
    ref = deepseek_v2_reference.run(config, run.seed, tokens, P - 1,
                                    routes=routes)
    lg = ref["logits"]
    want = lg[:, 1:]
    rel = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max()
    at = lg[:, :-1].gather(-1, served[..., None])[..., 0]
    gap = (lg[:, :-1].amax(-1) - at).max()
    lat_ref = ref["latent"]
    lat_rel = ((latent - lat_ref).abs().amax(-1)
               / lat_ref.abs().amax(-1)).max()
    return {"logits_rel": float(rel), "token_gap": float(gap),
            "malformed_calls": run.failed,
            "route_flip_share": ref["route_flip_share"],
            "route_flip_gap": ref["route_flip_gap"],
            "latent_cache_rel": float(lat_rel)}
