"""Distribution (counterpart of ``repro.dist``):

``sharding``    — logical-axis -> mesh-axis rule tables (train, serve,
                  decode), the resolver ``logical_spec``, DTensor
                  ``placements``, ``sharding_tree``, ``audit_rules``
                  and the leafwise update over a mesh
                  (``mesh_pdsgd_tree``);
``collectives`` — the torus gossip as per-direction tables (the ring
                  layout) and ``torus_gossip_pdsgd``, on one device or
                  over a `DeviceMesh` (a point-to-point shift per torus
                  direction);
``transport``   — the neighbor exchange of Eq. (3) in one process
                  (``InProcessTransport``) and between processes over
                  HMAC-framed sockets (``SocketTransport``,
                  ``PipelinedSocketTransport``), the multi-controller
                  deployment's channel (`launch.multihost`), and over a
                  `DeviceMesh`, one agent a rank (``ShardMapTransport``).
"""
from . import collectives, sharding, transport
from .transport import (FRAME_HEADER, WIRE_TAG_SIZE, InProcessTransport,
                        PipelinedSocketTransport, ShardMapTransport,
                        SocketTransport, Transport,
                        accumulate, capture_columns, derive_wire_secret,
                        flatten_one, link_message, merge_captures,
                        neighbor_lists, unflatten_one)

__all__ = ["collectives", "sharding", "transport", "FRAME_HEADER",
           "WIRE_TAG_SIZE", "InProcessTransport", "PipelinedSocketTransport",
           "ShardMapTransport", "SocketTransport", "Transport", "accumulate", "capture_columns",
           "derive_wire_secret", "flatten_one", "link_message",
           "merge_captures", "neighbor_lists", "unflatten_one"]
