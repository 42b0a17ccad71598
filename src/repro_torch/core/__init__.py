"""Core models of the port: performance model, MDP and ODS."""
