"""DMuon optimizer core (port of ``repro.core``): planning, layout, Gram NS,
update rules and the user-facing API."""
