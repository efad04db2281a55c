"""Parallel schedules: the host-level two-stage pipeline (`pipeline.two_stage_schedule`)."""
