"""Core PDSGD math: threefry randomness (`prng`), privacy draws
(`privacy`), topologies, schedules, the static mixing process and the
decentralized step (`pdsgd`).  Import from the submodules."""
