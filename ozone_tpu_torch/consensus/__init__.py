"""Quorum consensus (Raft) for the metadata ring and datanode pipelines.

Port of `ozone_tpu/consensus/` (the reference's Apache Ratis rings:
OzoneManagerRatisServer for OM HA, SCMRatisServerImpl for SCM HA,
XceiverServerRatis for datanode pipelines): the Raft core (`raft.py`)
and the ring that replicates the co-located OM and SCM state
(`meta_ring.py`).
"""

from ozone_tpu_torch.consensus.raft import (  # noqa: F401
    InProcessTransport,
    NotRaftLeaderError,
    RaftConfig,
    RaftNode,
)
