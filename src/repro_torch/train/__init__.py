"""The train, prefill and serve steps of the port."""
