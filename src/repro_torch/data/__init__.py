"""Deterministic, seeded synthetic data.

pointclouds.py  procedural 3D shapes (cls + per-point seg labels), drawn
                with torch generators on the device the caller names.
tokens.py       Markov LM token streams, restart-exact, with a background
                prefetch thread.
"""
