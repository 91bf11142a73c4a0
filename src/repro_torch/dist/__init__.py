"""Distribution (counterpart of ``repro.dist``):

``sharding``    — logical-axis -> mesh-axis rule tables (train, serve,
                  decode), the resolver ``logical_spec``, DTensor
                  ``placements``, ``sharding_tree``, ``audit_rules``
                  and the leafwise update over a mesh
                  (``mesh_pdsgd_tree``);
``collectives`` — the torus gossip as per-direction tables (the ring
                  layout) and the single-device forms of
                  ``torus_gossip_pdsgd``.

The multi-process transport is not ported yet (ROADMAP 7d).
"""
from . import collectives, sharding

__all__ = ["collectives", "sharding"]
