"""Train step and state (port of ``repro.train``)."""
