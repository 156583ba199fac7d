"""Step builders of the port (serving only so far; training is ROADMAP A)."""
