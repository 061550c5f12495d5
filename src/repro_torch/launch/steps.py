"""Step functions: train_step, prefill_step, decode_step; the port of
``repro/launch/steps.py``.

They close over the ModelConfig and take the model and tensors. The
reference's train step is a pure function of a state pytree; the port's
updates its state in place (the model's parameters, the optimizer's
moments), because at full size a second copy does not fit. The state is
``{"params": model, "opt": {"m", "v", "count"}, "step"}`` (``m`` and ``v``
dicts keyed by parameter name, ``count`` and ``step`` 0-d int32 tensors on
the host); :func:`state_to_reference` gives the reference's train-state
tree of it, whose checkpoint either package restores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ATTN_KINDS, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as mp
from repro_torch.models import transformer as tf
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)

AUX_LOSS_WEIGHT = 0.01


def make_positions(batch: int, seq: int, device="cpu") -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None] \
        .expand(batch, seq)


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def loss_fn(model: tf.Transformer, cfg: ModelConfig, batch, use_kernel=None):
    """Mean cross entropy of ``batch`` plus ``AUX_LOSS_WEIGHT`` times the
    MoE load-balancing loss (0 for a model without MoE). ``batch``:
    {"inputs": (B, S) token ids, or (B, S, D) float frames for a frames
    model (``TokenPipeline(frames_dim=D)``); "labels": (B, S) token ids},
    NumPy or tensors. Returns (loss, {"ce", "aux"})."""
    dev = model.device
    inputs = _on(batch["inputs"], dev)
    B, S = inputs.shape[:2]
    hidden, aux = tf.forward(model, cfg, inputs, make_positions(B, S, dev),
                             use_kernel)
    loss_sum, cnt = chunked_cross_entropy(
        model.lm_head, hidden, _on(batch["labels"], dev),
        chunk=cfg.loss_chunk, softcap=cfg.logit_softcap)
    loss = loss_sum / torch.clamp(cnt, min=1.0)
    return loss + AUX_LOSS_WEIGHT * aux, {"ce": loss, "aux": aux}


def make_train_step(cfg: ModelConfig, oc: OptConfig | None = None):
    """train_step(state, batch) -> (state, metrics): the loss's gradient
    (accumulated over ``cfg.microbatches`` splits of the batch, only one
    split's activations live at a time), then one AdamW update, all in
    place. metrics: ce, aux, loss, grad_norm (0-d tensors)."""
    oc = OptConfig() if oc is None else oc
    mb = max(cfg.microbatches, 1)

    def train_step(state, batch):
        model = state["params"]
        if mb == 1:
            loss, metrics = loss_fn(model, cfg, batch)
            loss.backward()
        else:
            # the grads of the splits add up in .grad (float32), then one
            # division: the reference's scan of sums over microbatches
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            splits = {k: torch.chunk(_on(v, model.device), mb)
                      for k, v in batch.items()}
            for i in range(mb):
                loss, _ = loss_fn(model, cfg,
                                  {k: v[i] for k, v in splits.items()})
                loss.backward()
                loss_sum = loss_sum + loss.detach()
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(mb)
            loss = loss_sum / mb
            # the reference's metrics here: "ce" is the mean of the splits'
            # whole losses (the aux term included), "aux" 0
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        gnorm = adamw_update(oc, model, state["opt"])
        model.zero_grad(set_to_none=True)
        state["step"] = state["step"] + 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)
    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device) -> dict:
    """A fresh train state: a trainable model with random weights from
    ``generator`` on ``device``, zero moments, step 0."""
    return state_of(tf.init_params(cfg, generator, device, trainable=True))


def state_of(model: tf.Transformer) -> dict:
    """A train state at step 0 around a trainable ``model``."""
    return {"params": model, "opt": init_opt_state(model),
            "step": torch.zeros((), dtype=torch.int32)}


def state_to_reference(state: dict) -> dict:
    """The reference's train-state tree of ``state`` (NumPy leaves, units
    stacked): what a checkpoint holds."""
    opt = state["opt"]
    return {"params": mp.to_reference(state["params"]),
            "opt": {"m": mp.named_to_reference(opt["m"]),
                    "v": mp.named_to_reference(opt["v"]),
                    "count": np.asarray(int(opt["count"]), np.int32)},
            "step": np.asarray(int(state["step"]), np.int32)}


def reference_state_like(cfg: ModelConfig, with_opt: bool = True) -> dict:
    """Zeros in the structure of the reference's train state (or of
    ``{"params"}`` alone): the ``like`` of a checkpoint restore."""
    params = mp.reference_shapes(cfg)
    if not with_opt:
        return {"params": params}

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}
    return {"params": params,
            "opt": {"m": zeros(params), "v": zeros(params),
                    "count": np.zeros((), np.int32)},
            "step": np.zeros((), np.int32)}


def load_state(state: dict, tree: dict) -> dict:
    """Copy a reference train-state tree (a restored checkpoint) into
    ``state`` in place; returns ``state``."""
    mp.load_tree(state["params"], tree["params"])
    mp.load_named(state["opt"]["m"], tree["opt"]["m"])
    mp.load_named(state["opt"]["v"], tree["opt"]["v"])
    state["opt"]["count"] = torch.tensor(int(tree["opt"]["count"]),
                                         dtype=torch.int32)
    state["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32)
    return state


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return tf.prefill(model, cfg, batch["inputs"])
    return prefill_step


def takes_graph(cfg: ModelConfig, device) -> bool:
    """Whether ``cfg``'s decode step on ``device`` runs as one CUDA graph
    (:class:`DecodeGraph`): on a card, where the attention is the
    ``decode_attention`` kernel, when every layer is an attention kind
    (whose decode reads the position as device data, ``nn/attention.py``
    ``attn_decode``) with a dense feed-forward, so that nothing in the
    step reads the position on the host or waits on the card. Latent
    attention (its cache read up to the position by a slice), MoE
    feed-forwards (their routing decides shapes on the host) and the
    recurrent mixers keep the eager step."""
    return torch.device(device).type == "cuda" \
        and all(kind in ATTN_KINDS for kind in cfg.layer_kinds()) \
        and all(cfg.ffn_kind(layer) != "moe"
                for layer in range(cfg.num_layers))


class DecodeGraph:
    """A model's decode step captured once as a CUDA graph and replayed
    for each token: the host issues one graph launch a step in place of
    the step's thousands of kernel launches.

    It owns the step's static inputs, the tokens (or frames) and the
    (B, 1) int32 positions. A call checks the position on the host
    (``models.transformer.check_position``), copies ``inputs`` into the
    static tokens and writes the position into the static positions, and
    replays. It returns the graph's static logits, which the next replay
    overwrites (``Server.generate`` and the benchmark's recorder read them
    first, in stream order), and the cache it was handed, which the step
    updates in place.

    It captures when it holds no graph for what it is handed: the graph is
    keyed on the model, on the cache tensors' data pointers, shapes,
    strides and dtypes, and on the inputs' shape and dtype, since a replay
    reads and writes the addresses the capture saw. Each prefill allocates
    a new cache, so expect a capture per ``generate`` call, unless the
    allocator hands the same memory back. Every capture takes one memory
    pool (``torch.cuda.graph_pool_handle``), so memory does not grow call
    by call: a capture takes the memory the graph before it freed, and
    that graph is dropped once the new one is captured. A capture first
    runs the step eagerly on the capture stream (its lazy set-up, such as
    cuBLAS's workspace for that stream, cannot happen inside a capture),
    then captures it and replays it; its time counts in the step that
    captured. It calls ``capture_begin`` itself, because
    ``torch.cuda.graph`` synchronises and empties the allocator's cache on
    entry, which would cost the next prefill its allocations.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.key = self.graph = self.model = None
        self.pool = self.stream = None
        self.inputs = self.positions = self.logits = None

    def __call__(self, model, cache, inputs, pos: int):
        tf.check_position(self.cfg, cache, pos)
        key = (id(model), torch.is_inference_mode_enabled(),
               tuple(inputs.shape), inputs.dtype,
               tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                     for c in tf.layer_caches(self.cfg, cache)
                     for t in c.values()))
        with trace.span("Model.decode", route="graph",
                        captured=key != self.key):
            if key != self.key:
                self._capture(model, cache, inputs, pos, key)
            else:
                self.inputs.copy_(inputs)
                self.positions.fill_(pos)
            self.graph.replay()
        ops.GRAPH_COUNTS["decode_graph.replays"] += 1
        return self.logits, cache

    def _capture(self, model, cache, inputs, pos: int, key) -> None:
        # the old graph's output goes first, so that the capture may take
        # its memory; the old graph itself goes once the new one holds the
        # pool, which PyTorch releases with the last graph that holds it
        self.key = self.model = self.logits = None
        dev = model.device
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(dev)
        self.inputs = inputs.clone()
        self.positions = torch.full((inputs.shape[0], 1), pos,
                                    dtype=torch.int32, device=dev)
        main = torch.cuda.current_stream(dev)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            tf.decode_step(model, self.cfg, cache, self.inputs,
                           self.positions)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool)
            try:
                logits, _ = tf.decode_step(model, self.cfg, cache,
                                           self.inputs, self.positions)
            finally:
                graph.capture_end()
        main.wait_stream(self.stream)
        # the model is held, so that its id in the key stays its own
        self.key, self.graph, self.model, self.logits = \
            key, graph, model, logits
        ops.GRAPH_COUNTS["decode_graph.captures"] += 1


def make_decode_step(cfg: ModelConfig, graph: bool = True):
    """The decode step ``(model, cache, inputs, pos) -> (logits, cache)``:
    ``models.transformer.decode_step`` at the int position ``pos``, as
    one CUDA graph (:class:`DecodeGraph`) where :func:`takes_graph`
    allows on the model's device, eagerly elsewhere or with
    ``graph=False`` (tests compare the two). Every step is a
    ``Model.decode`` span (``route`` "graph" or "eager", ``captured`` on
    the step that captured)."""
    graphed = DecodeGraph(cfg) if graph and takes_graph(cfg, "cuda") \
        else None

    def decode_step(model, cache, inputs, pos):
        if graphed is not None and model.device.type == "cuda":
            return graphed(model, cache, inputs, pos)
        with trace.span("Model.decode", route="eager", captured=False):
            return tf.decode_step(model, cfg, cache, inputs, pos)
    return decode_step
