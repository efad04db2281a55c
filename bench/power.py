"""The card's power draw, sampled by an `nvidia-smi` child process beside the window.

`nvidia-smi --query-gpu=timestamp,power.draw --loop-ms=100 -i <card>`
prints one reading a period, stamped with the card's own wall-clock time,
which places each sample in or out of the window whatever delay the pipe
adds (the child is line-buffered through `stdbuf` where the host has it).
The card is named by its UUID (or PCI bus id), as
`torch.cuda.get_device_properties` gives it, never by an index, which
CUDA_VISIBLE_DEVICES would renumber.  Energy over a window is the mean of
the samples inside it times its length; a window with no sample is an
error, never a guess.
"""

from __future__ import annotations

import datetime
import shutil
import signal
import subprocess
import threading

QUERY_TIMEOUT_S = 60
STOP_TIMEOUT_S = 10


def card_id(props) -> str:
    """The nvidia-smi id of a card from its torch device properties: GPU-<uuid>, else the bus id."""
    uuid = getattr(props, "uuid", None)
    if uuid:
        text = str(uuid)
        return text if text.startswith("GPU-") else f"GPU-{text}"
    bus = getattr(props, "pci_bus_id", None)
    if bus is None:
        raise RuntimeError("the card's UUID and PCI bus id are both unknown to torch")
    domain, device = getattr(props, "pci_domain_id", 0), getattr(props, "pci_device_id", 0)
    return f"{domain:08X}:{bus:02X}:{device:02X}.0"


def query(card: str, fields: str) -> str:
    """One `nvidia-smi --query-gpu=<fields>` line of the card, without units."""
    out = subprocess.run(
        ["nvidia-smi", "-i", card, f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=QUERY_TIMEOUT_S, check=True,
    )
    return out.stdout.strip()


def _wall(stamp: str) -> float:
    """nvidia-smi's local `YYYY/MM/DD HH:MM:SS.mmm` as seconds since the epoch."""
    return datetime.datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp()


class PowerSampler:
    """power.draw of one card every `period_ms`, as (wall-clock s, watts) pairs.

    Use as a context manager around the window: the child starts on entry
    and is stopped (SIGINT, then SIGTERM) and waited for on exit.
    """

    def __init__(self, card: str, period_ms: int = 100):
        self.card = card
        self.period_ms = period_ms
        self.samples: list[tuple[float, float]] = []
        self.errors: list[str] = []
        self._proc = None
        self._thread = None

    def __enter__(self):
        cmd = ["nvidia-smi", "-i", self.card, "--query-gpu=timestamp,power.draw",
               "--format=csv,noheader,nounits", f"--loop-ms={self.period_ms}"]
        if shutil.which("stdbuf"):
            cmd = ["stdbuf", "-oL", *cmd]
        self._proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, bufsize=1)
        self._thread = threading.Thread(target=self._read, name="bench-power", daemon=True)
        self._thread.start()
        return self

    def _read(self):
        for line in self._proc.stdout:
            try:
                stamp, watts = line.rsplit(",", 1)
                self.samples.append((_wall(stamp), float(watts)))
            except ValueError:
                self.errors.append(line.strip())

    def __exit__(self, *exc):
        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGKILL):
            self._proc.send_signal(sig)
            try:
                self._proc.wait(timeout=STOP_TIMEOUT_S)
                break
            except subprocess.TimeoutExpired:
                continue
        self._thread.join(timeout=STOP_TIMEOUT_S)
        err = self._proc.stderr.read()
        if err.strip():
            self.errors.append(err.strip())
        self._proc.stderr.close()
        self._proc.stdout.close()

    def energy_j(self, t0: float, t1: float) -> tuple[float, int]:
        """(joules over wall-clock [t0, t1], samples used): mean draw inside times length."""
        inside = [w for t, w in self.samples if t0 <= t <= t1]
        if not inside:
            raise RuntimeError(
                f"no power sample inside the window ({len(self.samples)} in all; "
                f"errors: {self.errors[:3]})")
        return sum(inside) / len(inside) * (t1 - t0), len(inside)
