"""Model state and the behaviour aggregator."""
