"""Device time of FAST-9 + 3x3 NMS per pyramid level, and of the whole ORB
extractor per frame, read from a JAX profiler trace.

    python tools/profile_fast_nms.py [--calls 50]

For each level of the 8-level, 1.2-scale pyramid of a rendered 1280x720 and
1920x1080 frame, the jitted ``fast_and_nms`` runs ``--calls`` times inside
a trace. Device time per call is the union of the GPU plane's kernel
intervals over the window, divided by the calls. Its byte bound is the
level image read plus the raw and NMS maps written, over the card's memory
bandwidth (NVIDIA data sheets). ``extract_orb_features`` is timed the same
way per frame, which gives FAST+NMS's share of extraction. Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# Device memory bandwidth by device_kind (NVIDIA data sheets).
PEAK_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12}


def peak_bytes_per_s(device_kind: str) -> float:
    for key, value in PEAK_BYTES_PER_S.items():
        if key in device_kind:
            return value
    raise KeyError(f"no bandwidth peak for device kind {device_kind!r}")


def _union_ns(intervals) -> float:
    total, end = 0.0, -np.inf
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def device_busy_ns(trace_dir: str) -> tuple[float, str]:
    """Union of kernel intervals on the first GPU plane of the trace, and
    a one-line account of which lines it read."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))
    data = ProfileData.from_file(path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        raise RuntimeError("no GPU plane in the trace")
    lines = list(planes[0].lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    chosen = streams or [ln for ln in lines if ln.name == "XLA Ops"]
    intervals = [
        (e.start_ns, e.start_ns + e.duration_ns)
        for ln in chosen for e in ln.events
    ]
    account = "lines " + ", ".join(
        f"{ln.name}({sum(1 for _ in ln.events)})" for ln in lines
    ) + f"; read {[ln.name for ln in chosen]}"
    return _union_ns(intervals), account


def time_calls(fn, arg, calls: int) -> tuple[float, float, str]:
    """(device ms per call, wall ms per call, trace account)."""
    import jax

    jax.block_until_ready(fn(arg))  # compile and warm
    trace_dir = tempfile.mkdtemp(prefix="fast_nms_trace_")
    try:
        with jax.profiler.trace(trace_dir):
            start = time.perf_counter()
            for _ in range(calls):
                out = fn(arg)
            jax.block_until_ready(out)
            wall = time.perf_counter() - start
        busy, account = device_busy_ns(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return busy / calls / 1e6, wall / calls * 1e3, account


def level_images(image, height: int, width: int):
    """The extractor's 8 pyramid levels (1.2 scale) as float32 grey levels."""
    import jax
    import jax.numpy as jnp

    from pilotguru.vo.features import resize_grey_levels

    base = jnp.round(image * 255.0).astype(jnp.int32)
    for level in range(8):
        lh = max(int(round(height / 1.2**level)), 32)
        lw = max(int(round(width / 1.2**level)), 32)
        levels = base if level == 0 else resize_grey_levels(base, lh, lw)
        yield level, lh, lw, jax.block_until_ready(levels.astype(jnp.float32))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args()

    import jax

    from pilotguru.cli._common import setup_compile_cache
    from pilotguru.vo.features import extract_orb_features, fast_and_nms
    from synthetic import parallax_frames

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    peak = peak_bytes_per_s(dev.device_kind)
    print(f"card: {card}; device_kind: {dev.device_kind}; "
          f"devices: {jax.device_count()}; calls: {args.calls}")
    fast = jax.jit(lambda im: fast_and_nms(im, 20.0))
    account = ""
    for width, height, fx in ((1280, 720, 700.0), (1920, 1080, 1050.0)):
        gray = next(parallax_frames(width=width, height=height, frames=1,
                                    num_points=2400, fx=fx, period_frames=60.0))
        image = jax.device_put(np.asarray(gray, np.float32) / 255.0, dev)
        total_dev = total_bound = 0.0
        for level, lh, lw, img in level_images(image, height, width):
            dev_ms, wall_ms, account = time_calls(fast, img, args.calls)
            bound_ms = 3 * 4 * lh * lw / peak * 1e3
            total_dev += dev_ms
            total_bound += bound_ms
            print(f"{height}p L{level} {lh}x{lw}: fast+nms device "
                  f"{dev_ms * 1e3:.1f} us, wall {wall_ms * 1e3:.1f} us, byte "
                  f"bound {bound_ms * 1e3:.2f} us, roofline share "
                  f"{bound_ms / dev_ms:.3f}")
        ext_dev, ext_wall, _ = time_calls(extract_orb_features, image,
                                          args.calls)
        print(f"{height}p all levels: fast+nms device {total_dev * 1e3:.1f} us "
              f"(byte bound {total_bound * 1e3:.2f} us, share "
              f"{total_bound / total_dev:.3f}); extract_orb_features device "
              f"{ext_dev * 1e3:.1f} us/frame, wall {ext_wall * 1e3:.1f} us; "
              f"fast+nms share of extraction {total_dev / ext_dev:.3f}")
    print(f"trace: {account}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
