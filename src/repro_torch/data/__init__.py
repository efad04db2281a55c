"""Deterministic, seeded synthetic data.

pointclouds.py  procedural 3D shapes (cls + per-point seg labels), drawn
                with torch generators on the device the caller names.

The JAX package's `data/tokens.py` (LM token streams) waits for the LM
substrate (ROADMAP.md, queue A item 11).
"""
