"""The port's runnable examples (twins of ``example/``)."""
