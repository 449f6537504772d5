"""The benchmark's own machinery: finding cells, configurations, phases and
metric readers by name, the card's identity, the loader-wait timer, the
profiler reduction and the peak rates. It imports nothing of the port at
module level and never imports JAX."""
