"""Fault-tolerance runtime: fault injection, elastic hooks and the
supervised resilient loop."""
