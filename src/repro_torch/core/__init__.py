"""Algorithm 1: topology, mixing, server, gossip and compression, the
shared step body, and its engines: the tree engine on the stacked dict
(feddec, fedavg), the flat (n_agents, D) buffer and the sweep lattice."""
