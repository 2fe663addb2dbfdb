"""Literal-semantics oracles for numeric parity tests.

These are deliberately naive sequential re-derivations of the reference
algorithms' documented semantics (cited per function), used as ground truth
for the vectorized device implementations. They mirror *behavior*, not code.
"""

from __future__ import annotations

import math

import numpy as np


def merge_time_series(components):
    """Pointer-walk merge. Semantics of MergeTimeSeries
    (/root/reference/src/interpolation/align_time_series.cc:29-113)."""
    comps = [list(map(int, c)) for c in components]
    start_time = max(c[0] for c in comps)
    end_time = min(c[-1] for c in comps)
    if end_time < start_time:
        return [], []

    current = []
    for c in comps:
        i = 0
        while c[i] < start_time:
            i += 1
        if c[i] > start_time:
            current.append(i - 1)
        else:
            current.append(i)

    events, times = [], []
    while True:
        events.append(list(current))
        times.append(max(comps[k][current[k]] for k in range(len(comps))))
        next_times = []
        for k in range(len(comps)):
            ni = current[k] + 1
            if ni >= len(comps[k]):
                return times, events
            next_times.append(comps[k][ni])
        nt = min(next_times)
        for k in range(len(comps)):
            if comps[k][current[k] + 1] == nt:
                current[k] += 1


def make_interpolation_intervals(reference_ts, interpolation_ts):
    """Nested-interval construction. Semantics of MakeInterpolationIntervals
    (/root/reference/src/interpolation/align_time_series.cc:155-196).
    Returns list (per reference idx) of tuples (ref_end, itp_end, start, end).
    """
    ref = list(map(int, reference_ts))
    itp = list(map(int, interpolation_ts))
    result = []
    latest = min(itp[0], ref[0])
    i = 0
    for r, rts in enumerate(ref):
        intervals = []
        while i < len(itp) and itp[i] <= rts:
            its = itp[i]
            if its > latest and i > 0 and r > 0:
                intervals.append((r, i, latest, its))
            latest = its
            i += 1
        if i > 0 and r > 0 and i < len(itp) and rts > latest:
            intervals.append((r, i, latest, rts))
        latest = rts
        result.append(intervals)
    return result


def smooth_time_series(values, timestamps, targets, sigma):
    """Pointer-walk Gaussian-CDF smoothing. Semantics of SmoothTimeSeries
    (/root/reference/src/slam/smoothing.cc:56-98)."""
    values = np.asarray(values, dtype=np.float64)
    ts = list(map(float, timestamps))
    out = np.zeros((len(targets),) + values.shape[1:], dtype=np.float64)
    left = 0
    right = 0
    for t_idx, target in enumerate(targets):
        while left + 1 < len(values) and (target - ts[left + 1]) > 3 * sigma:
            left += 1
        while right + 1 < len(values) and (ts[right] - target) < 3 * sigma:
            right += 1
        prev_cdf = 0.0
        for j in range(left, right):
            mid = (ts[j] + ts[j + 1]) / 2.0
            cdf = 0.5 * (1.0 + math.erf((mid - target) / (math.sqrt(2.0) * sigma)))
            out[t_idx] += values[j] * (cdf - prev_cdf)
            prev_cdf = cdf
        out[t_idx] += values[right] * (1.0 - prev_cdf)
    return out


def time_averaged_value(values, times_usec, start_usec, end_usec):
    """Trapezoid interval average. Semantics of TimeSeries::TimeAveragedValue
    (/root/reference/include/interpolation/time_series.hpp:134-189).
    Returns (value, is_valid)."""
    values = list(map(float, values))
    times = list(map(int, times_usec))
    if start_usec < times[0] or end_usec > times[-1]:
        return float("nan"), False

    def most_recent(t):
        i = 0
        while i < len(times) and times[i] <= t:
            i += 1
        return i - 1

    def sec(a, b):
        return (b - a) * 1e-6

    def lerp(li, ri, t):
        lt = sec(times[li], t)
        rt = sec(t, times[ri])
        tot = sec(times[li], times[ri])
        return (lt / tot) * values[ri] + (rt / tot) * values[li]

    si = most_recent(start_usec)
    ei = most_recent(end_usec)
    total = 0.0
    for j in range(si + 1, ei):
        total += sec(times[j], times[j + 1]) * 0.5 * (values[j] + values[j + 1])
    lv = lerp(si, si + 1, start_usec)
    rv = lerp(ei, ei + 1, end_usec)
    if si == ei:
        total += (lv + rv) * 0.5 * sec(start_usec, end_usec)
    else:
        total += (lv + values[si + 1]) * 0.5 * sec(start_usec, times[si + 1])
        total += (values[ei] + rv) * 0.5 * sec(times[ei], end_usec)
    return total / sec(start_usec, end_usec), True


def rotation_rate_to_quat(rate, duration_sec):
    """Exponential map. Semantics of RotationMotionToQuaternion
    (/root/reference/src/geometry/geometry.cc:6-22)."""
    rx, ry, rz = map(float, rate)
    omega = math.sqrt(rx * rx + ry * ry + rz * rz)
    half = omega * duration_sec * 0.5
    s = math.sin(half) / (omega + 1e-30)
    return np.array([math.cos(half), rx * s, ry * s, rz * s])


def quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_rotate(q, v):
    w = q[0]
    u = np.asarray(q[1:])
    v = np.asarray(v, dtype=np.float64)
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def integrate_motion_sequence(
    rates, accs, durations_sec, global_bias, local_bias, v0, q0=None
):
    """Sequential strapdown chain. Semantics of IntegrateMotion applied in a
    loop (/root/reference/src/geometry/geometry.cc:24-53, driven at
    velocity.cc:95-102). Returns (orientations [T,4], velocities [T,3])."""
    q = np.array([1.0, 0, 0, 0]) if q0 is None else np.asarray(q0, np.float64)
    v = np.asarray(v0, dtype=np.float64).copy()
    qs, vs = [], []
    for rate, acc, dt in zip(rates, accs, durations_sec):
        a_cal = np.asarray(acc, np.float64) + np.asarray(local_bias, np.float64)
        a_glob = quat_rotate(q, a_cal) + np.asarray(global_bias, np.float64)
        v = v + a_glob * dt
        q = quat_mul(q, rotation_rate_to_quat(rate, dt))
        qs.append(q.copy())
        vs.append(v.copy())
    return np.array(qs), np.array(vs)


# ---------------------------------------------------------------------------
# AccelerometerCalibrator oracle
# ---------------------------------------------------------------------------


class AccelerometerCalibratorOracle:
    """Literal re-derivation of AccelerometerCalibrator
    (/root/reference/src/calibration/velocity.cc:29-256): sequential
    integration over interpolation intervals, loss = time-normalized sum of
    squared travel-distance mismatches, with the reference's hand-derived
    gradient formulas (including its post-step-rotation approximation for
    the local-bias term and the 1e-5 norm guard)."""

    def __init__(self, gps_times, gps_speeds, rot_times, rot_rates, acc_times, accs):
        self.gps_speeds = np.asarray(gps_speeds, np.float64)
        ev_times, ev_idx = merge_time_series([rot_times, acc_times])
        self.event_times = ev_times
        self.event_idx = ev_idx
        self.rot_rates = np.asarray(rot_rates, np.float64)
        self.accs = np.asarray(accs, np.float64)
        self.intervals = make_interpolation_intervals(gps_times, ev_times)

    def _piece_data(self, interval):
        _, itp_end, start, end = interval
        rot_i, acc_i = self.event_idx[itp_end]
        dt = (end - start) * 1e-6
        return self.rot_rates[rot_i], self.accs[acc_i], dt

    def eval(self, params):
        params = np.asarray(params, np.float64)
        g_bias, l_bias, v0 = params[0:3], params[3:6], params[6:9]
        grad = np.zeros(9)
        loss = 0.0
        q = np.array([1.0, 0, 0, 0])
        v = v0.copy()
        total_usec = 0
        total_weighted_rot = np.zeros((3, 3))
        for intervals in self.intervals:
            travel = np.zeros(3)
            ref_dist = 0.0
            outcomes = []
            for interval in intervals:
                ref_end = interval[0]
                rate, acc, dt = self._piece_data(interval)
                a_glob = quat_rotate(q, acc + l_bias) + g_bias
                v = v + a_glob * dt
                q = quat_mul(q, rotation_rate_to_quat(rate, dt))
                outcomes.append((q.copy(), v.copy(), interval[3] - interval[2]))
                travel += dt * v
                ref_dist += dt * self.gps_speeds[ref_end]
            diff = np.linalg.norm(travel) - ref_dist
            loss += diff * diff
            dl_dt = 2.0 * diff * travel / (np.linalg.norm(travel) + 1e-5)
            for q_out, _, dur_usec in outcomes:
                dt = dur_usec * 1e-6
                total_usec += dur_usec
                t_sec = total_usec * 1e-6
                grad[0:3] += t_sec * dt * dl_dt
                rmat = _quat_to_mat(q_out)
                total_weighted_rot += rmat * dt
                grad[3:6] += dt * (total_weighted_rot.T @ dl_dt)
                grad[6:9] += dt * dl_dt
        total_sec = total_usec * 1e-6
        return loss / total_sec, grad / total_sec

    def integrate_trajectory(self, params):
        """Returns {event_index: (orientation, velocity)} like
        IntegrateTrajectory (velocity.cc:199-256): final values per event."""
        params = np.asarray(params, np.float64)
        g_bias, l_bias, v0 = params[0:3], params[3:6], params[6:9]
        q = np.array([1.0, 0, 0, 0])
        v = v0.copy()
        result = {}
        for intervals in self.intervals:
            for interval in intervals:
                itp_end = interval[1]
                rate, acc, dt = self._piece_data(interval)
                a_glob = quat_rotate(q, acc + l_bias) + g_bias
                v = v + a_glob * dt
                q = quat_mul(q, rotation_rate_to_quat(rate, dt))
                result[itp_end] = (q.copy(), v.copy())
        return result


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def fit_motion_velocities(
    gps_times,
    gps_speeds,
    rot_times,
    rot_rates,
    acc_times,
    accs,
    batch_size=40,
    shift_step=5,
    max_iters=500,
):
    """Sequential sliding-window fit with scipy L-BFGS-B, mirroring the
    reference main loop (fit_motion.cc:179-269): per-window solve from zero
    init, trajectory replay, per-event speed collection, cross-window
    averaging. Returns (event_times_usec, averaged_speeds) over covered
    events (pre-smoothing)."""
    from scipy.optimize import minimize

    gps_times = np.asarray(gps_times)
    per_event = {}
    for start in range(0, len(gps_times), shift_step):
        end = min(start + batch_size, len(gps_times))
        cal = AccelerometerCalibratorOracle(
            gps_times[start:end],
            np.asarray(gps_speeds)[start:end],
            rot_times,
            rot_rates,
            acc_times,
            accs,
        )
        if not any(cal.intervals):
            continue
        res = minimize(
            cal.eval,
            np.zeros(9),
            jac=True,
            method="L-BFGS-B",
            options={"maxiter": max_iters, "ftol": 1e-14, "gtol": 1e-9},
        )
        for ev, (_, vel) in cal.integrate_trajectory(res.x).items():
            per_event.setdefault(ev, []).append(np.linalg.norm(vel))
    events = sorted(per_event)
    # Event indices are window-relative to the merged series, which is
    # global here because the IMU streams are shared across windows.
    full = AccelerometerCalibratorOracle(
        gps_times, np.asarray(gps_speeds), rot_times, rot_rates, acc_times, accs
    )
    times = np.asarray([full.event_times[e] for e in events], np.int64)
    speeds = np.asarray([np.mean(per_event[e]) for e in events])
    return times, speeds


class GPSInterpolationObjectiveOracle:
    """Literal re-derivation of GPSInterpolationObjective
    (/root/reference/src/interpolate_velocity.cc:53-214): per-GPS-interval
    distance mismatch + finite-difference acceleration magnitude +
    acceleration smoothness, each L1+L2 weighted, with the reference's
    analytic (sub)gradients, plus its InitToAverages and the clipped
    gradient-descent loop (gradient_descent.cc:18-33)."""

    def __init__(self, gps_times, gps_speeds, frame_times, l1, l2, w_v, w_a, w_s):
        self.gps_speeds = list(map(float, gps_speeds))
        self.ft = list(map(int, frame_times))
        self.l1, self.l2 = l1, l2
        self.w_v, self.w_a, self.w_s = w_v, w_a, w_s
        self.groups = make_interpolation_intervals(gps_times, frame_times)

    def init_to_averages(self):
        x = [0.0] * len(self.ft)
        for g, intervals in enumerate(self.groups):
            for _, itp_end, _, _ in intervals:
                x[itp_end] = self.gps_speeds[g]
        return np.asarray(x)

    def eval(self, x):
        x = np.asarray(x, np.float64)
        grad = np.zeros_like(x)
        obj = 0.0
        for g, intervals in enumerate(self.groups):
            integrated = 0.0
            duration = 0.0
            for _, itp_end, s, e in intervals:
                dt = (e - s) * 1e-6
                integrated += x[itp_end] * dt
                duration += dt
            diff = integrated - self.gps_speeds[g] * duration
            sign = 1.0 if diff > 0 else -1.0
            obj += self.l1 * self.w_v * abs(diff) + self.l2 * self.w_v * diff * diff
            for _, itp_end, s, e in intervals:
                dt = (e - s) * 1e-6
                grad[itp_end] += self.l1 * self.w_v * sign * dt
                grad[itp_end] += 2.0 * self.l2 * self.w_v * diff * dt
        for i in range(1, len(self.ft)):
            inv = 1.0 / ((self.ft[i] - self.ft[i - 1]) * 1e-6)
            a = (x[i] - x[i - 1]) * inv
            s = 1 if a > 0 else -1
            obj += self.l1 * self.w_a * abs(a) + self.l2 * self.w_a * a * a
            grad[i - 1] -= (self.l1 * self.w_a * s + 2 * self.l2 * self.w_a * a) * inv
            grad[i] += (self.l1 * self.w_a * s + 2 * self.l2 * self.w_a * a) * inv
        for i in range(1, len(self.ft) - 1):
            invp = 1.0 / ((self.ft[i] - self.ft[i - 1]) * 1e-6)
            invn = 1.0 / ((self.ft[i + 1] - self.ft[i]) * 1e-6)
            ap = (x[i] - x[i - 1]) * invp
            an = (x[i + 1] - x[i]) * invn
            d = an - ap
            s = 1 if d > 0 else -1
            obj += self.l1 * self.w_s * abs(d) + self.l2 * self.w_s * d * d
            grad[i - 1] += (self.l1 * self.w_s * s + 2 * self.l2 * self.w_s * d) * invp
            grad[i + 1] += (self.l1 * self.w_s * s + 2 * self.l2 * self.w_s * d) * invn
            grad[i] -= (self.l1 * self.w_s * s + 2 * self.l2 * self.w_s * d) * (
                invp + invn
            )
        return obj, grad

    def optimize(self, iters, lr, decay, clip_min=-10.0, clip_max=10.0):
        x = self.init_to_averages()
        cur = lr
        for _ in range(iters):
            _, g = self.eval(x)
            x = x - cur * np.clip(g, clip_min, clip_max)
            cur *= decay
        return x


def fixed_forward_axis_loss(
    gps_times, gps_speeds, rot_times, rot_rates, acc_times, accs, params
):
    """Literal three-term FixedForwardAxisCalibrator objective
    (/root/reference/src/calibration/velocity.cc:270-470): sequential
    orientation chain, travel-distance + acceleration-match + axis-norm
    penalty. params = [g_bias(3), l_bias(3), axis(3), velocities(E)]."""
    params = np.asarray(params, np.float64)
    g_bias, l_bias, axis = params[0:3], params[3:6], params[6:9]
    velocities = params[9:]

    ev_times, ev_idx = merge_time_series([rot_times, acc_times])
    intervals = make_interpolation_intervals(gps_times, ev_times)
    rot_rates = np.asarray(rot_rates, np.float64)
    accs = np.asarray(accs, np.float64)
    gps_speeds = np.asarray(gps_speeds, np.float64)

    axis_norm = np.linalg.norm(axis)
    loss_axis = 5e-3 * (axis_norm - 1.0) ** 2

    q = np.array([1.0, 0, 0, 0])
    loss_travel = 0.0
    loss_accel = 0.0
    for g, group in enumerate(intervals):
        travel = np.zeros(3)
        ref_dist = 0.0
        for _, itp_end, s_us, e_us in group:
            dt = (e_us - s_us) * 1e-6
            rot_i, acc_i = ev_idx[itp_end]
            r_pre = _quat_to_mat(q)
            travel += dt * velocities[itp_end] * (r_pre @ axis)
            ref_dist += dt * gps_speeds[g]
            q = quat_mul(q, rotation_rate_to_quat(rot_rates[rot_i], dt))
            r_post = _quat_to_mat(q)
            s_now = velocities[itp_end]
            s_next = velocities[min(itp_end + 1, len(velocities) - 1)]
            delta_v_axis = (s_next * r_post - s_now * r_pre) @ axis
            imu_delta_v = dt * (g_bias + r_pre @ (accs[acc_i] + l_bias))
            loss_accel += np.sum((delta_v_axis - imu_delta_v) ** 2)
        diff = np.linalg.norm(travel) - ref_dist
        loss_travel += diff * diff
    return loss_travel + loss_accel + loss_axis
