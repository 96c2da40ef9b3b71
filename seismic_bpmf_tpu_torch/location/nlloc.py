"""Glue to the external NLLoc locator (http://alomax.free.fr/nlloc/).

Counterpart of `seismic_bpmf_tpu/location/nlloc.py` (reference parity:
BPMF/NLLoc_utils.py and `Event.relocate_NLLoc`, BPMF/dataset.py:2271-2462)
without pandas: picks come in as an `ops.picks.PickTable` (or the JAX
package's DataFrame), and the predicted travel times go out as one.  Every
file written is byte for byte the JAX package's on the same inputs: the
obs, control and travel-time grid files, and the .hyp parsing with its
left- to right-handed covariance flip.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from decimal import Decimal
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..ops.picks import PickTable, is_null
from ..utils.observe import logger
from ..utils.time import timedelta_sec


def _as_datetime64(t) -> np.datetime64:
    if hasattr(t, "to_datetime64"):        # a pandas Timestamp
        t = t.to_datetime64()
    if isinstance(t, np.datetime64):
        return t.astype("datetime64[ns]")
    return np.datetime64(str(t), "ns")


def _as_table(table) -> PickTable:
    """A PickTable, or the JAX package's DataFrame as one."""
    return table if isinstance(table, PickTable) else PickTable.from_frame(
        table)


# ---------------------------------------------------------------------------
# obs / control file writers (BPMF/NLLoc_utils.py:282-639)
# ---------------------------------------------------------------------------

def _fmt_pick_line(station, phase, t: np.datetime64, err: float,
                   weight: int):
    # the fields of Timestamp.strftime('%Y%m%d', '%H%M', '%S.%f'):
    # microseconds, the nanoseconds dropped
    s = str(t.astype("datetime64[us]"))
    return (
        f"{station}\t?\t?\t?\t{phase}\t?\t"
        f"{s[0:4]}{s[5:7]}{s[8:10]}\t{s[11:13]}{s[14:16]}\t"
        f"{s[17:19]}.{s[20:26]}\tGAU\t{err}\t-1.0\t-1.0\t-1.0\t{weight}\n"
    )


def write_nlloc_obs(
    origin_time,
    picks,
    stations: Sequence[str],
    filename: str,
    path: str = "",
    err_min: float = 0.04,
):
    """Append the NLLoc .obs picks file.

    `picks`: a PickTable (or DataFrame) with `{P,S}_abs_picks` and,
    optionally, `{P,S}_unc_sec`.  Stations without a pick get a
    zero-weight placeholder at the origin time (reference behaviour,
    BPMF/NLLoc_utils.py:339-409)."""
    picks = _as_table(picks)
    row = {str(s): i for i, s in enumerate(picks.stations)}
    ot = _as_datetime64(origin_time)
    with open(os.path.join(path, filename), "a") as f:
        for st in stations:
            for ph in ("P", "S"):
                col = f"{ph}_abs_picks"
                i = row.get(str(st))
                has_pick = (col in picks.columns and i is not None
                            and not is_null(picks[col][i]))
                if has_pick:
                    err_col = f"{ph}_unc_sec"
                    err = (
                        max(err_min, float(picks[err_col][i]))
                        if err_col in picks.columns
                        and not is_null(picks[err_col][i])
                        else err_min
                    )
                    t = _as_datetime64(picks[col][i])
                    f.write(_fmt_pick_line(st, ph, t, err, 1))
                else:
                    f.write(_fmt_pick_line(st, ph, ot, 0.0, 0))
        f.write(" \n")


def write_nlloc_control(
    ctrl_filename: str,
    out_filename: str,
    obs_filename: str,
    input_path: str,
    output_path: str,
    basename: str,
    trans: str = "GLOBAL",
    method: str = "EDT_OT_WT_ML",
    locsearch: str = "OCT",
    locsearch_params: str = "10 10 10 0.001 100000 10000 0 0",
    phases: Sequence[str] = ("P", "S"),
):
    """Write the NLLoc control file (BPMF/NLLoc_utils.py:412-639)."""
    with open(os.path.join(input_path, ctrl_filename), "w") as f:
        f.write("CONTROL 0 54321\n")
        f.write(f"TRANS {trans}\n")
        f.write("LOCSIG seismic_bpmf_tpu\n")
        f.write(f"LOCFILES {os.path.join(input_path, obs_filename)} "
                f"NLLOC_OBS {os.path.join(input_path, basename)} "
                f"{os.path.join(output_path, out_filename)}\n")
        f.write(f"LOCSEARCH {locsearch} {locsearch_params}\n")
        f.write(f"LOCMETH {method} 9999.0 4 -1 -1 -1 -1 -1 1\n")
        f.write("LOCGAU 0.2 0.0\n")
        f.write("LOCGAU2 0.01 0.05 2.0\n")
        f.write("LOCQUAL2ERR 0.1 0.2 0.4 0.8 99999.9\n")
        f.write("LOCPHASEID P P p G Pn Pg\n")
        f.write("LOCPHASEID S S s G Sn Sg\n")
        f.write("LOCHYPOUT SAVE_NLLOC_ALL\n")


def _station_row(station_coords, sta) -> Tuple:
    """(longitude, latitude, depth_km) of a station, from a `Network` of
    the port or the JAX package's metadata DataFrame indexed by station
    (depth_km 0.0 where it has no such column)."""
    if hasattr(station_coords, "stations_idx"):
        i = int(station_coords.stations_idx(sta)[0])
        return (station_coords.longitude[i], station_coords.latitude[i],
                station_coords.depth[i])
    row = station_coords.loc[sta]
    return row["longitude"], row["latitude"], row.get("depth_km", 0.0)


def write_nlloc_grids(
    travel_times: Dict[str, Dict[str, np.ndarray]],
    grid_spec: Dict,
    station_coords,
    input_path: str,
    basename: str,
):
    """Write NLLoc-format travel-time grids (.hdr + .buf) per station and
    phase.

    travel_times : {phase: {station: (n_lon, n_lat, n_dep) seconds}} with
    the BPMF/pykonal axis convention, written as NLLoc's (x=lon, y=lat,
    z=dep) float32 buffers (BPMF/NLLoc_utils.py:199-279).
    grid_spec : origin_lon, origin_lat, origin_dep, d_lon_km, d_lat_km,
    d_dep_km, shape (nx, ny, nz).
    station_coords : a `Network`, or a DataFrame indexed by station with
    longitude, latitude and optionally depth_km."""
    nx, ny, nz = grid_spec["shape"]
    for ph, stations in travel_times.items():
        for sta, tt in stations.items():
            root = os.path.join(
                input_path, f"{basename}.{ph}.{sta}.time"
            )
            tt = np.asarray(tt, np.float32).reshape(nx, ny, nz)
            with open(root + ".buf", "wb") as f:
                tt.astype("<f4").tofile(f)
            lon, lat, depth_km = _station_row(station_coords, sta)
            with open(root + ".hdr", "w") as f:
                f.write(
                    f"{nx} {ny} {nz}  "
                    f"{grid_spec['origin_lon']} {grid_spec['origin_lat']} "
                    f"{grid_spec['origin_dep']}  "
                    f"{grid_spec['d_lon_km']} {grid_spec['d_lat_km']} "
                    f"{grid_spec['d_dep_km']} TIME\n"
                )
                f.write(f"{sta} {lon} {lat} {-depth_km}\n")
                f.write("TRANSFORM GLOBAL\n")


# ---------------------------------------------------------------------------
# output parsing (BPMF/NLLoc_utils.py:85-196)
# ---------------------------------------------------------------------------

def _origin_time(info) -> Optional[np.datetime64]:
    """The GEOGRAPHIC line's origin time as the JAX package reads it:
    `Timestamp('Y-M-DTH:M:<max(0, sec)>')`, then, for negative seconds,
    minus `Timedelta(sec, unit='s')`.  None where that string is no
    time."""
    sec = float(info[7])
    sec_str = str(max(0.0, sec))
    try:
        whole = Decimal(sec_str)
        if not 0 <= whole < 60:
            return None
        t = (np.datetime64(f"{int(info[2]):04d}-{int(info[3]):02d}-"
                           f"{int(info[4]):02d}T{int(info[5]):02d}:"
                           f"{int(info[6]):02d}", "ns")
             + np.timedelta64(int(whole * 10**9), "ns"))
    except Exception:
        return None
    if sec < 0.0:
        # pandas' float-to-ns cast of the unit 's': whole seconds, then
        # the fraction rounded to 9 digits
        base = int(sec)
        t -= np.timedelta64(base * 10**9 + int(round(sec - base, 9) * 10**9),
                            "ns")
    return t


def read_nlloc_outputs(
    filename: str, path: str = ""
) -> Tuple[Optional[Dict], Optional[PickTable]]:
    """Parse a NLLoc .hyp file.

    Returns (hypocenter dict with origin_time (datetime64[ns]), latitude,
    longitude, depth, tt_rms, success, cov_mat (right-handed, BPMF
    convention) and the expectation location; a PickTable of the
    per-station predicted travel times and residuals, columns
    {P,S}_tt_sec and {P,S}_residuals_sec), or (None, None)."""
    hypocenter: Dict = {}
    success = False
    hypocenter_info = None
    uncertainty_info = None
    tt_rms = np.nan
    with open(os.path.join(path, filename), "r") as f:
        lines = f.readlines()
    for line in lines:
        ls = line.split()
        if not ls:
            continue
        if ls[0] == "NLLOC":
            success = ls[2].strip('"') == "LOCATED"
        elif ls[0] == "GEOGRAPHIC":
            hypocenter_info = ls
        elif ls[0] == "QUALITY":
            tt_rms = float(ls[8])
        elif ls[0] == "STATISTICS":
            uncertainty_info = ls
        elif ls[0] == "STAT_GEOG":
            hypocenter["exp_latitude"] = float(ls[2])
            hypocenter["exp_longitude"] = float(ls[4])
            hypocenter["exp_depth"] = float(ls[6])
            break
    hypocenter["success"] = success
    if hypocenter_info is None:
        return None, None
    origin_time = _origin_time(hypocenter_info)
    if origin_time is None:
        return None, None
    hypocenter["origin_time"] = origin_time
    hypocenter["latitude"] = float(hypocenter_info[9])
    hypocenter["longitude"] = float(hypocenter_info[11])
    hypocenter["depth"] = float(hypocenter_info[13])
    hypocenter["tt_rms"] = tt_rms
    if uncertainty_info is not None:
        cov = np.zeros((3, 3), np.float32)
        cov[0, 0] = float(uncertainty_info[8])
        cov[0, 1] = float(uncertainty_info[10])
        cov[0, 2] = float(uncertainty_info[12])
        cov[1, 1] = float(uncertainty_info[14])
        cov[1, 2] = float(uncertainty_info[16])
        cov[2, 2] = float(uncertainty_info[18])
        # NLLoc covariance is left-handed (z down): flip the z axis
        cov[2, :] *= -1.0
        cov[:, 2] *= -1.0
        hypocenter["cov_mat"] = cov + cov.T - np.diag(cov.diagonal())

    # phase block
    per_sta: Dict[str, Dict] = {}
    in_phase = False
    for line in lines:
        if line.startswith("PHASE "):
            in_phase = True
            continue
        if line.startswith("END_PHASE"):
            break
        if not in_phase:
            continue
        info = line.split()
        if len(info) < 10:
            continue
        sta, ph = info[0], info[4]
        if ph not in ("P", "S"):
            continue
        # predicted travel time and residual: the two fields after the
        # '>' separator (robust to NLLoc versions' pick column counts; the
        # reference hardcodes indexes 15/16, BPMF/NLLoc_utils.py:176-183)
        if ">" in info:
            sep = info.index(">")
            tt, res = float(info[sep + 1]), float(info[sep + 2])
        else:
            tt, res = float(info[15]), float(info[16])
        per_sta.setdefault(sta, {})[ph] = (tt, res)
    columns = {}
    for ph in ("P", "S"):
        pairs = [d.get(ph, (np.nan, np.nan)) for d in per_sta.values()]
        columns[f"{ph}_tt_sec"] = np.array([p[0] for p in pairs], np.float64)
        columns[f"{ph}_residuals_sec"] = np.array([p[1] for p in pairs],
                                                  np.float64)
    order = ["P_tt_sec", "P_residuals_sec", "S_tt_sec", "S_residuals_sec"]
    return hypocenter, PickTable(list(per_sta),
                                 {c: columns[c] for c in order})


# ---------------------------------------------------------------------------
# relocation through the binary (BPMF/dataset.py:2271-2462)
# ---------------------------------------------------------------------------

def relocate_nlloc(
    event,
    stations: Optional[Sequence[str]] = None,
    input_path: Optional[str] = None,
    output_path: Optional[str] = None,
    basename: str = "bpmf",
    nlloc_bin: str = "NLLoc",
    cleanup: bool = True,
    **control_kwargs,
):
    """Relocate an event with NLLoc: write obs and control files, run the
    binary, parse the output, update the event in place (its location,
    origin time, covariance, `arrival_times_table` of the predicted
    travel times and absolute arrivals, the uncertainties).

    On failure (no binary, no output, not located) the event is returned
    un-relocated with `aux_data['NLLoc_reloc'] = False` (reference
    behaviour, BPMF/dataset.py:2388-2421)."""
    picks = event.picks_table
    if picks is None:
        raise RuntimeError("event has no picks; call pick_PS_phases first")
    stations = list(stations if stations is not None else event.stations)
    tmpdir = None
    if input_path is None:
        tmpdir = tempfile.mkdtemp(prefix="nlloc_")
        input_path = output_path = tmpdir
    obs = f"{event.id}.obs"
    ctrl = f"{event.id}.in"
    out = f"{event.id}"
    obs_path = os.path.join(input_path, obs)
    if os.path.exists(obs_path):
        os.remove(obs_path)
    write_nlloc_obs(event.origin_time, picks, stations, obs,
                    path=input_path)
    write_nlloc_control(
        ctrl, out, obs, input_path, output_path, basename, **control_kwargs
    )
    try:
        subprocess.run(
            [nlloc_bin, os.path.join(input_path, ctrl)],
            capture_output=True, timeout=600, check=True,
        )
        import glob as _glob

        hyps = [
            fn for fn in _glob.glob(os.path.join(output_path, f"{out}.*.hyp"))
            if "sum" not in os.path.basename(fn)
        ]
        if not hyps:
            raise FileNotFoundError("no NLLoc .hyp output")
        hypo, predicted = read_nlloc_outputs(os.path.basename(hyps[0]),
                                             output_path)
        if hypo is None or not hypo["success"]:
            raise RuntimeError("NLLoc did not locate")
        event.longitude = hypo["longitude"]
        event.latitude = hypo["latitude"]
        event.depth = hypo["depth"]
        event.origin_time = hypo["origin_time"]
        if "cov_mat" in hypo:
            event.cov_mat = hypo["cov_mat"]
            event.set_aux_data({"cov_mat": hypo["cov_mat"]})
        event.set_aux_data(
            {"NLLoc_reloc": True, "tt_rms": hypo["tt_rms"]}
        )
        # absolute predicted arrivals = new origin time + predicted tt
        # (the reference's `{ph}_abs_arrival_times` columns,
        # BPMF/dataset.py:2488-2491)
        for ph in ("P", "S"):
            tt = predicted[f"{ph}_tt_sec"]
            at = np.full(len(tt), np.datetime64("NaT"), "datetime64[ns]")
            for i in np.flatnonzero(np.isfinite(tt)):
                at[i] = event.origin_time + timedelta_sec(tt[i])
            predicted.columns[f"{ph}_abs_arrival_times"] = at
        event.arrival_times_table = predicted
        event.hor_ver_uncertainties()
        return event
    except Exception as e:
        logger.warning("NLLoc did not relocate event %s: %r", event.id, e)
        event.set_aux_data({"NLLoc_reloc": False})
        return event
    finally:
        if cleanup and tmpdir is not None:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)
