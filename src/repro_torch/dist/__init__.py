"""Decentralized exchange on a ("pod", "data") torus (counterpart of
``repro.dist``): the per-direction tables of the ring layout and the
single-device forms of the torus gossip.  Import from the submodules."""
