"""Versioned datasets and snapshots, snapshot coordination and replica
management: the parts of the paper's data model the port's serving slice
runs on."""
from repro_torch.core.replica import ReplicaManager, SharedTensorPolicy  # noqa: F401
from repro_torch.core.snapshotter import (DataNode, IngestNode,  # noqa: F401
                                          Mutation, SnapshotCoordinator)
from repro_torch.core.versioned import (Version, VersionedArray,  # noqa: F401
                                        VersionedStore)
