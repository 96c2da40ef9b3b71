"""The port's NLLoc glue (`location/nlloc.py`) against the JAX package's.

The same picks, travel times and .hyp outputs go through both: the obs,
control and grid files must be byte for byte the JAX package's, the
parsed hypocenter and predicted travel times equal, and `relocate_nlloc`
through a stub NLLoc executable (a script written in `tmp_path` that drops
a .hyp where the control file says) must update the event as the JAX one
does.  No NLLoc binary is in the repository, so no real round trip runs.
"""

import os
import stat
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from seismic_bpmf_tpu.data.events import Event as JaxEvent  # noqa: E402
from seismic_bpmf_tpu.data.network import Network as JaxNetwork  # noqa: E402
from seismic_bpmf_tpu.location import nlloc as jnl  # noqa: E402

from seismic_bpmf_tpu_torch.data import Event, Network  # noqa: E402
from seismic_bpmf_tpu_torch.location import nlloc as tnl  # noqa: E402
from seismic_bpmf_tpu_torch.ops.picks import PickTable  # noqa: E402

# the .hyp of tests/test_models.py:100-125, and the same event located
# with negative origin seconds (NLLoc writes them for an origin just
# before a minute)
HYP = """NLLOC "loc.1" "LOCATED" "see comment"
SIGNATURE "x"
GEOGRAPHIC  OT 2012 07 26 01 00 {sec}  Lat 40.3123 Long 30.2456 Depth 8.75
QUALITY  Pmax 1e10 MFmin 1 MFmax 2 RMS 0.123 Nphs 8 Gap 100 Dist 10 Mamp 0 0 Mdur 0 0
STATISTICS  ExpectX 1 Y 2 Z 3  CovXX 0.4 XY 0.01 XZ -0.02 YY 0.3 YZ 0.03 ZZ 0.6 EllAz1 0 Dip1 0 Len1 0 Az2 0 Dip2 0 Len2 0 Len3 0
STAT_GEOG  ExpectLat 40.3125 Long 30.2458 Depth 8.70
PHASE ID Ins Cmp On Pha  FM Date HrMn Sec Err ErrMag Coda Amp Per Prior > TTpred Res Weight StaLoc(X Y Z) SDist SAzim RAz RDip RQual Tcorr
ST1    ?    ?    ? P      ? 20120726 0100    2.5000 GAU  4.00e-02 -1.00e+00 -1.00e+00 -1.00e+00    1.0000 >    2.3456   0.0544    1.0     1.0 2.0 -0.1    10.0  90.0  90.0  90.0  9  0.0
ST1    ?    ?    ? S      ? 20120726 0100    4.2500 GAU  4.00e-02 -1.00e+00 -1.00e+00 -1.00e+00    1.0000 >    4.1000   0.0250    1.0     1.0 2.0 -0.1    10.0  90.0  90.0  90.0  9  0.0
ST2    ?    ?    ? S      ? 20120726 0100    5.0000 GAU  4.00e-02 -1.00e+00 -1.00e+00 -1.00e+00    1.0000 >    5.1234  -0.1234    1.0     1.0 2.0 -0.1    10.0  90.0  90.0  90.0  9  0.0
END_PHASE
END_NLLOC
"""


def _picks_frame():
    """Picks with a NaT, nanosecond times and an uncertainty column."""
    return pd.DataFrame(
        {
            "P_abs_picks": [pd.Timestamp("2012-07-26T01:00:02.5"), pd.NaT,
                            pd.Timestamp("2012-07-26T01:00:03.123456789")],
            "S_abs_picks": [pd.Timestamp("2012-07-26T01:00:04.25"),
                            pd.Timestamp("2012-07-26T01:00:05.0"), pd.NaT],
            "P_unc_sec": [0.01, np.nan, 0.2],
        },
        index=pd.Index(["ST1", "ST2", "ST3"], name="stations"),
    )


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("as_table", [False, True])
@pytest.mark.parametrize("origin", ["2012-07-26T01:00:00",
                                    "2012-07-26T01:00:00.000000500"])
def test_obs_file_is_byte_equal(tmp_path, as_table, origin):
    df = _picks_frame()
    stations = ["ST1", "ST2", "ST3", "ST4"]   # ST4 has no pick row
    jnl.write_nlloc_obs(origin, df, stations, "j.obs", path=str(tmp_path))
    picks = PickTable.from_frame(df) if as_table else df
    tnl.write_nlloc_obs(np.datetime64(origin, "ns") if as_table else origin,
                        picks, stations, "t.obs", path=str(tmp_path))
    # appended twice, as the writers append
    jnl.write_nlloc_obs(origin, df, stations[:2], "j.obs", path=str(tmp_path))
    tnl.write_nlloc_obs(origin, picks, stations[:2], "t.obs",
                        path=str(tmp_path))
    assert _read(tmp_path / "t.obs") == _read(tmp_path / "j.obs")


@pytest.mark.parametrize("kwargs", [{}, dict(
    trans="SIMPLE 40.0 30.0 0.0", method="GAU_ANALYTIC",
    locsearch="GRID", locsearch_params="1000 1 1")])
def test_control_file_is_byte_equal(tmp_path, kwargs):
    for mod, name in ((jnl, "j.in"), (tnl, "t.in")):
        mod.write_nlloc_control(name, "ev", "ev.obs", str(tmp_path),
                                str(tmp_path / "out"), "bpmf", **kwargs)
    assert _read(tmp_path / "t.in") == _read(tmp_path / "j.in")


@pytest.mark.parametrize("coords", ["network", "frame"])
def test_grid_files_are_byte_equal(tmp_path, coords):
    rng = np.random.default_rng(5)
    shape = (4, 3, 5)
    stations = ["ST1", "ST2"]
    tts = {ph: {s: rng.uniform(0, 10, size=shape) for s in stations}
           for ph in ("P", "S")}
    spec = dict(origin_lon=30.0, origin_lat=40.0, origin_dep=-1.0,
                d_lon_km=0.5, d_lat_km=0.5, d_dep_km=1.0, shape=shape)
    lat, lon, elev = [40.1, 40.25], [30.3, 30.05], [0.0, 1250.0]
    md = pd.DataFrame({"stations": stations, "networks": ["XX"] * 2,
                       "latitude": lat, "longitude": lon,
                       "elevation_m": elev})
    jcoords = JaxNetwork.from_dataframe(md).metadata.set_index("stations")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jnl.write_nlloc_grids(tts, spec, jcoords, str(jdir), "bpmf")
    tcoords = (Network.from_arrays(stations, networks=["XX"] * 2,
                                   latitude=lat, longitude=lon,
                                   elevation_m=elev)
               if coords == "network" else jcoords)
    tnl.write_nlloc_grids(tts, spec, tcoords, str(tdir), "bpmf")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 8
    for name in names:
        assert _read(tdir / name) == _read(jdir / name), name


@pytest.mark.parametrize("sec", ["2.125", "0.0000", "-0.2500", "59.9999"])
def test_hyp_parsing_matches_jax(tmp_path, sec):
    (tmp_path / "ev.hyp").write_text(HYP.format(sec=sec))
    jh, jp = jnl.read_nlloc_outputs("ev.hyp", str(tmp_path))
    th, tp = tnl.read_nlloc_outputs("ev.hyp", str(tmp_path))
    assert set(th) == set(jh)
    for k, v in jh.items():
        if k == "origin_time":
            assert th[k] == np.datetime64(v.to_datetime64(), "ns"), (th[k], v)
        elif k == "cov_mat":
            assert th[k].dtype == v.dtype
            np.testing.assert_array_equal(th[k], v)
        else:
            assert th[k] == v, k
    assert list(tp.stations) == list(jp.index)
    assert list(tp.columns) == list(jp.columns)
    for c in jp.columns:
        np.testing.assert_array_equal(tp[c], jp[c].to_numpy())
    pd.testing.assert_frame_equal(tp.to_frame(), jp)


def test_hyp_without_a_location_gives_none(tmp_path):
    (tmp_path / "ev.hyp").write_text('NLLOC "loc.1" "REJECTED" "x"\n')
    assert tnl.read_nlloc_outputs("ev.hyp", str(tmp_path)) == (None, None)
    assert jnl.read_nlloc_outputs("ev.hyp", str(tmp_path)) == (None, None)


def _stub_nlloc(tmp_path, hyp: str) -> str:
    """An executable that reads the control file's LOCFILES line and drops
    `hyp` as <output root>.<date>.grid0.loc.hyp (and a .sum.hyp that the
    relocation must skip), as NLLoc does."""
    path = tmp_path / "NLLoc_stub"
    hyp_file = tmp_path / "stub.hyp"
    hyp_file.write_text(hyp)
    path.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        "for line in open(sys.argv[1]):\n"
        "    if line.startswith('LOCFILES'):\n"
        "        root = line.split()[4]\n"
        f"shutil.copy({str(hyp_file)!r}, root + '.20120726.010002.grid0.loc.hyp')\n"
        "open(root + '.sum.grid0.loc.hyp', 'w').write('garbage')\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _events():
    df = _picks_frame()
    mv = np.array([[1.0, 2.0], [1.5, 2.8], [2.0, 3.5]])
    kw = dict(latitude=40.3, longitude=30.2, depth=9.0, sampling_rate=25.0)
    je = JaxEvent("2012-07-26T01:00:00.5", mv, list(df.index), ["P", "S"],
                  **kw)
    je.picks = df
    te = Event("2012-07-26T01:00:00.5", mv, list(df.index), ["P", "S"], **kw)
    te.picks_table = PickTable.from_frame(df)
    return je, te


@pytest.mark.parametrize("sec", ["2.125", "-0.2500"])
def test_relocate_nlloc_through_a_stub_matches_jax(tmp_path, sec):
    nlloc_bin = _stub_nlloc(tmp_path, HYP.format(sec=sec))
    je, te = _events()
    for ev, d in ((je, "j"), (te, "t")):
        (tmp_path / d).mkdir()
        out = ev.relocate(routine="nlloc", input_path=str(tmp_path / d),
                          output_path=str(tmp_path / d), nlloc_bin=nlloc_bin)
        assert out is ev and ev.aux_data["NLLoc_reloc"] is True
    assert _read(tmp_path / "t" / f"{te.id}.obs") == _read(
        tmp_path / "j" / f"{je.id}.obs")
    for f in (f"{te.id}.in",):
        jt = _read(tmp_path / "j" / f).replace(b"/j/", b"/t/")
        assert _read(tmp_path / "t" / f) == jt
    assert (te.longitude, te.latitude, te.depth) == (
        je.longitude, je.latitude, je.depth)
    assert te.origin_time == je.origin_time
    np.testing.assert_array_equal(te.cov_mat, je.cov_mat)
    for k in ("tt_rms", "hmax_unc", "hmin_unc", "vmax_unc", "az_hmax_unc",
              "az_hmin_unc", "pl_vmax_unc"):
        assert te.aux_data[k] == je.aux_data[k], k
    assert te.hmax_unc == je.aux_data["hmax_unc"]
    jat, tat = je.arrival_times, te.arrival_times_table
    assert list(tat.stations) == list(jat.index)
    assert list(tat.columns) == list(jat.columns)
    for c in jat.columns:
        want = jat[c].to_numpy()
        if want.dtype.kind == "M":
            want = want.astype("datetime64[ns]")
        np.testing.assert_array_equal(tat[c], want)


@pytest.mark.parametrize("how", ["missing", "not_located"])
def test_failed_nlloc_leaves_the_event_unrelocated(tmp_path, how):
    nlloc_bin = (str(tmp_path / "no_such_NLLoc") if how == "missing"
                 else _stub_nlloc(tmp_path, HYP.format(sec="2.125").replace(
                     '"LOCATED"', '"REJECTED"')))
    je, te = _events()
    before = (te.longitude, te.latitude, te.depth, te.origin_time)
    for ev in (je, te):
        ev.relocate_NLLoc(nlloc_bin=nlloc_bin)
        assert ev.aux_data["NLLoc_reloc"] is False
    assert (te.longitude, te.latitude, te.depth, te.origin_time) == before
    assert te.arrival_times_table is None and not hasattr(te,
                                                          "arrival_times")


def test_relocate_nlloc_needs_picks():
    ev = Event("2012-07-26T01:00:00", np.zeros((1, 2)), ["A"], ["P", "S"])
    with pytest.raises(RuntimeError, match="picks"):
        ev.relocate(routine="nlloc")
    with pytest.raises(ValueError, match="unknown relocation routine"):
        ev.relocate(routine="hypoinverse")
