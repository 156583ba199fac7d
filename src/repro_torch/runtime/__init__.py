"""Runtime support of the port's training loop (fault tolerance)."""
