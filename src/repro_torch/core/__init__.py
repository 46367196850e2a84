"""Algorithm 1 on the flat (n_agents, D) buffer: topology, mixing,
server, gossip and the flat engine."""
