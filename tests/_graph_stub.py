"""Stand-ins for the card's graph machinery, for the port's CPU tests.

`stub_capture` is an `ArtifactCache`/`GraphedStep` capture function that
captures nothing: its graph's replay recomputes the stage into the static
outputs, and, like a real replay, counts no launch from Python.
`TimingEvent` stands in for the timing events a traced capture records
(`graphs._timing_event`).  `stub_graphs(monkeypatch)` gives every
accelerator made after it a stub-capturing `ArtifactCache` and stub timing
events, so the CPU runs the graph layer's replay path.
"""

from repro_torch.core import accelerator, graphs
from repro_torch.core.engine import result_map

STREAM = 7  # the handle of the stub's capture stream


class StubGraph:
    """Stands in for a captured graph: a replay recomputes fn into the static outputs."""

    def __init__(self, fn, static, outputs):
        self.fn, self.static, self.outputs = fn, static, outputs

    def replay(self):
        with graphs.registry.recording(STREAM):
            new = self.fn(*self.static)
        result_map(lambda dst, src: dst.copy_(src), self.outputs, new)


def stub_capture(fn, static, what):
    with graphs.registry.recording(STREAM) as launches:
        outputs = fn(*static)
    return StubGraph(fn, static, outputs), outputs, launches


class TimingEvent:
    """Stands in for a timing event of a traced capture: stamped on a scripted
    clock when made (recorded), finished unless `done` is cleared."""

    clock = 0.0
    done = True

    def __init__(self):
        TimingEvent.clock += 1.25
        self.t = TimingEvent.clock

    def query(self):
        return TimingEvent.done

    def elapsed_time(self, end):
        return end.t - self.t


def stub_graphs(monkeypatch) -> None:
    """Accelerators made from now on replay stub graphs, also on the CPU."""
    init = accelerator.PC2IMAccelerator.__init__

    def with_artifacts(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.artifacts = graphs.ArtifactCache(self.device, capture=stub_capture)

    monkeypatch.setattr(accelerator.PC2IMAccelerator, "__init__", with_artifacts)
    monkeypatch.setattr(graphs, "_timing_event", TimingEvent)
    monkeypatch.setattr(TimingEvent, "done", True)
    accelerator.clear_cache()
