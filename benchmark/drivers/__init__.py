"""The traffic generators, one per kind of traffic mix, named by a mix's ``driver`` key."""
