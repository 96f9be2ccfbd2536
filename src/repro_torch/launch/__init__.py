"""Launch layer of the port: the serving entry point
(counterpart of ``repro/launch``; ``serve`` only so far)."""
