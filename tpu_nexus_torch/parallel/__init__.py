"""Process groups, meshes, sharding rules, the collective seam, and the
sequence-parallel attentions (ring, Ulysses) of the port."""
