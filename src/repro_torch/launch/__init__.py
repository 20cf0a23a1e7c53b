"""Step functions of the port: the serving prefill so far."""
