"""The program under test, as the cells build and drive it: the sharded
store from a configuration's layout, the mutation batches of the harness's
stream, and the digests of the snapshots the program publishes; the
model server of a model configuration, holding the weights the harness
drew. This is the only harness module besides the drivers that imports
``repro_torch``.
"""
from __future__ import annotations

import dataclasses

import torch

from benchlib import model_weights
from benchlib.reference import view_digest_tensor
from benchlib.stream import KroneckerStream, Layout


def layout_of(config: dict, epoch_blocks: int) -> Layout:
    return Layout(config["base_blocks"], config["base_epochs"], epoch_blocks)


def edge_capacity(config: dict, layout: Layout, epochs: int) -> int:
    """Per-shard edge rows: the base and ``epochs`` stream epochs of adds,
    spread over the initial shards, with a quarter to spare for the
    unevenness of the hash split (a row is never reclaimed: deletes
    tombstone it)."""
    rows = (layout.base_blocks + epochs * layout.epoch_blocks) \
        * config["block_edges"]
    return int(rows / config["layout"]["shards"] * 1.25) \
        + config["block_edges"]


def build_store(config: dict, e_max: int, device):
    from repro_torch.core.replica import ShardPlanner
    from repro_torch.graph.sharded import ShardedDynamicGraph

    lay = config["layout"]
    planner = (ShardPlanner(**lay["planner"]) if lay.get("planner")
               else None)
    return ShardedDynamicGraph(lay["shards"], 1 << config["generator"]
                               ["scale"], e_max, planner=planner,
                               device=device)


def mutation_batch(stream: KroneckerStream, layout: Layout, epoch: int):
    """The program's ``MutationBatch`` for store epoch ``epoch``."""
    from repro_torch.core.versioned import Version
    from repro_torch.graph.dyngraph import MutationBatch

    def host(t: torch.Tensor):
        return t.cpu().numpy()

    add_s, add_d = stream.blocks(layout.added_blocks(epoch))
    del_s, del_d = stream.blocks(layout.deleted_blocks(epoch))
    return MutationBatch(Version(epoch, 0), add_src=host(add_s),
                         add_dst=host(add_d), del_src=host(del_s),
                         del_dst=host(del_d))


def digest_of(view) -> torch.Tensor:
    """The snapshot digest of one of the program's join views (a device
    tensor, read later)."""
    return view_digest_tensor(view.offsets, view.src, view.dst,
                              view.out_degree, view.in_degree)


# what the port's architecture must say for the plain reference
# (``model_reference.py``) to be the same model: one full-attention
# mixer kind, SwiGLU, RMSNorm, rotary positions, token embeddings,
# untied, unscaled, with no extra norms or softcaps
_DENSE_DECODER = {"pattern": ("attn",), "ffn": "swiglu", "norm": "rms",
                  "rope": True, "pos_emb": "rope", "embed_mode": "tokens",
                  "tie_embeddings": False, "scale_embeddings": False,
                  "sandwich_norm": False, "qk_norm": False,
                  "logit_softcap": 0.0, "attn_softcap": 0.0,
                  "mlp_bias": False, "n_experts": 0}


def model_config(config: dict):
    """The port's ``ModelConfig`` of a model configuration: the
    architecture ``config["arch"]`` at the configuration's sizes. Raises
    where the port's architecture is not the decoder the configuration
    and its reference describe."""
    from repro_torch.configs import get_config

    s = model_weights.shape_of(config)
    cfg = dataclasses.replace(
        get_config(config["arch"]), num_layers=s["layers"], d_model=s["d"],
        n_heads=s["hq"], n_kv_heads=s["hkv"], head_dim=s["hd"],
        d_ff=s["ff"], vocab_size=s["vocab"],
        rope_theta=float(config["rope_theta"]))
    want = dict(_DENSE_DECODER, qkv_bias=config["qkv_bias"],
                tie_embeddings=config["tie_word_embeddings"])
    got = {k: getattr(cfg, k) for k in want}
    got["pattern"] = tuple(got["pattern"])
    if got != want:
        raise ValueError(f"{config['arch']} is not the configuration's "
                         f"decoder: {got} != {want}")
    return cfg


def model_server(config: dict, seed: int, device):
    """``launch.serve.Server`` over the port's model holding the weights
    ``model_weights`` draws from ``seed``, each copied into the parameter
    of its name, after ``nn.layers.strict_matmul()`` as
    ``launch.serve.main`` calls it."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.transformer import Transformer
    from repro_torch.nn.layers import strict_matmul

    strict_matmul()
    cfg = model_config(config)
    model = Transformer(cfg, device)
    named = dict(model.named_parameters())
    specs = model_weights.specs(config)
    if sorted(named) != sorted(name for name, _, _ in specs):
        raise ValueError("the port's parameters are not the drawn ones: "
                         f"{sorted(set(named) ^ {n for n, _, _ in specs})}")
    with torch.no_grad():
        for name, shape, kind in specs:
            if tuple(named[name].shape) != shape:
                raise ValueError(f"{name}: the port holds "
                                 f"{tuple(named[name].shape)}, not {shape}")
            named[name].copy_(model_weights.draw(config, seed, name, shape,
                                                 kind, device))
    return Server(cfg, model)
