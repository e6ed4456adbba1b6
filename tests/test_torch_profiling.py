"""The padded profiler window (``sddm_tpu_torch.utils.profiling``) and the
probe that measures why it is padded, on the CPU: the window holds the
block's events and its margins, and the probe refuses to run without a
card."""

import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, record_function

from sddm_tpu_torch import profiler_window_probe
from sddm_tpu_torch.utils.profiling import PROFILE_MARGIN_S, profiled


@pytest.mark.parametrize("margin_s", [0.0, 0.02, PROFILE_MARGIN_S])
def test_profiled_window_keeps_the_block_between_its_margins(margin_s):
    start = time.perf_counter()
    with profiled(ProfilerActivity.CPU, margin_s=margin_s) as prof:
        inner = time.perf_counter()
        with record_function("probe_block"):
            torch.ones(8).add_(1)
        inner = time.perf_counter() - inner
    wall = time.perf_counter() - start
    blocks = [e for e in prof.key_averages()
              if e.key == "probe_block" and e.device_type == DeviceType.CPU]
    assert len(blocks) == 1 and blocks[0].count == 1
    assert wall >= inner + 2 * margin_s


def test_profile_margin_covers_the_skew_measured_on_the_card():
    # the device's timestamps stepped to 7.7 ms before the host's launch on an
    # H100; the margin must hold that with room to spare
    assert PROFILE_MARGIN_S >= 5 * 7.7e-3


def test_probe_refuses_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert profiler_window_probe.main(["--seconds", "0"]) == 2
    assert "runs on the card" in capsys.readouterr().err


def test_retry_windows_start_at_the_margin_and_widen():
    """A measurement's later windows only widen: the default margin three
    times, then longer ones, the last with the CPU activity traced too."""
    from sddm_tpu_torch.utils.profiling import PROFILE_MARGIN_S, RETRY_WINDOWS

    margins = [m for m, _ in RETRY_WINDOWS]
    assert margins[:3] == [PROFILE_MARGIN_S] * 3 and margins == sorted(margins)
    assert RETRY_WINDOWS[-1][1] and not any(cpu for _, cpu in RETRY_WINDOWS[:3])
