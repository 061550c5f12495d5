"""The program under test, as the cells build and drive it: the sharded
store from a configuration's layout, the mutation batches of the harness's
stream, and the digests of the snapshots the program publishes. This is
the only harness module besides the drivers that imports ``repro_torch``.
"""
from __future__ import annotations

import torch

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
