"""Fluid-flow simulator of the DSI pipeline (the port's copy of
``repro.sim``)."""
