"""Pipeline schedules: GPipe over stage devices (`pipeline.pipeline_forward`) and the
host-level two-stage form (`pipeline.two_stage_schedule`)."""

from repro_torch.parallel.pipeline import pipeline_forward, two_stage_schedule  # noqa: F401
