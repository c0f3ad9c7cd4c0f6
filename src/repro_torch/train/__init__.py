"""Training infrastructure: the optimizer the ULEEN trainer uses."""
