"""Tests of the benchmark: on the CPU, and one marked gpu that runs on the card."""
