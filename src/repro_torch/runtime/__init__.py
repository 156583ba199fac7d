"""Runtime support of the port's training loop: fault tolerance, the
logical-axis sharding rules and the collectives of data parallelism."""
