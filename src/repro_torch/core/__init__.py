"""The paper's primary contribution: versioned datasets + snapshots,
protocol dataflow, replica-coherence data management, distributed views,
Lamport-clock event delivery."""
from repro_torch.core.clock import Event, EventLog, LamportClock, Stamp  # noqa: F401
from repro_torch.core.protocol_dataflow import (  # noqa: F401
    CoalescingOutput, Dataflow, Egress, FIFOScheduler, Ingress, Message,
    PriorityScheduler, Protocol, Vertex)
from repro_torch.core.replica import ReplicaManager, SharedTensorPolicy  # noqa: F401
from repro_torch.core.snapshotter import (DataNode, IngestNode,  # noqa: F401
                                          Mutation, SnapshotCoordinator)
from repro_torch.core.versioned import (Version, VersionedArray,  # noqa: F401
                                        VersionedStore)
from repro_torch.core.views import View  # noqa: F401
