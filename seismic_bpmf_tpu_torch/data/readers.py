"""Pluggable data readers.

Copy of `seismic_bpmf_tpu.data.readers`.  Reader protocol (reference:
BPMF/data_reader_examples.py:4-44):

    reader(where, network=..., stations=..., channels=..., location=...,
           starttime=..., endtime=..., **kwargs) -> Stream

Readers provided:
  - `data_reader_hdf5`: the native format, one HDF5 file per time window
    with `waveforms/<station>/<channel>` datasets and root attrs
    `starttime` (ISO string) and `sampling_rate`; h5py is imported inside
    the functions that read and write it;
  - `data_reader_mseed`: the reference tutorial's miniSEED folder
    convention (BPMF/data_reader_examples.py:115-214), through obspy when
    it is installed and through `data.mseed` / `data.stationxml` otherwise.
"""

from __future__ import annotations

import fnmatch
import functools
import glob
import os
from typing import Optional

import numpy as np

from ..utils.time import epoch_from_utc
from .stream import Stream, Trace, from_obspy


def write_hdf5_continuous(
    path: str, stream: Stream, sampling_rate: Optional[float] = None
):
    """Write a Stream to the native HDF5 continuous-data format."""
    import h5py

    with h5py.File(path, "w") as f:
        t0 = min(tr.stats.starttime for tr in stream)
        f.attrs["starttime"] = str(np.datetime64(int(t0 * 1e9), "ns"))
        f.attrs["sampling_rate"] = (
            sampling_rate
            if sampling_rate is not None
            else stream[0].stats.sampling_rate
        )
        g = f.create_group("waveforms")
        for tr in stream:
            sta = tr.stats.station
            cha = tr.stats.channel or f"HH{tr.stats.component}"
            if sta not in g:
                g.create_group(sta)
                g[sta].attrs["network"] = tr.stats.network
            g[sta].create_dataset(cha, data=tr.data.astype(np.float32))
            g[sta][cha].attrs["starttime_offset_sec"] = tr.stats.starttime - t0


def data_reader_hdf5(
    where,
    network=None,
    stations=None,
    channels=None,
    location=None,
    starttime=None,
    endtime=None,
    **kwargs,
) -> Stream:
    """Read the native HDF5 continuous-data format into a Stream."""
    import h5py

    out = Stream()
    with h5py.File(where, "r") as f:
        t0 = epoch_from_utc(str(f.attrs["starttime"]))
        sr = float(f.attrs["sampling_rate"])
        g = f["waveforms"]
        for sta in g.keys():
            if stations is not None and sta not in stations:
                continue
            net = g[sta].attrs.get("network", "")
            for cha in g[sta].keys():
                if channels is not None and not any(
                    fnmatch.fnmatch(cha, pat)
                    for pat in np.atleast_1d(channels)
                ):
                    continue
                ofs = float(g[sta][cha].attrs.get("starttime_offset_sec", 0.0))
                out += Trace(
                    g[sta][cha][()],
                    station=sta,
                    network=str(net),
                    channel=cha,
                    sampling_rate=sr,
                    starttime=t0 + ofs,
                )
    if starttime is not None or endtime is not None:
        out = out.slice(starttime, endtime)
    return out


def data_reader_template(
    where,
    network=None,
    stations=None,
    channels=None,
    location=None,
    starttime=None,
    endtime=None,
    **kwargs,
):
    """Skeleton showing the data-reader protocol: every reader takes a path
    plus network/stations/channels/location/starttime/endtime selectors and
    returns a `Stream` (reference parity:
    BPMF/data_reader_examples.py:4-44, which likewise returns an empty
    stream for users to fill in).  See `data_reader_hdf5` /
    `data_reader_mseed` for working implementations."""
    traces = Stream()
    # read your data into traces
    return traces


def _resp_dirs(where):
    # reference convention: StationXML per station under where/resp
    # (BPMF/data_reader_examples.py:208); also a resp folder beside the
    # data root
    return (os.path.join(where, "resp"), os.path.join(where, "..", "resp"))


@functools.lru_cache(maxsize=8)
def _parsed_inventory(stamped: tuple):
    from .stationxml import Inventory, parse_stationxml

    inv = Inventory()
    for path, _, _ in stamped:
        inv = inv + parse_stationxml(path)
    return inv


def _response_inventory(where):
    """The StationXML files under both resp folders, in `read_inventory`'s
    order, parsed once for each set of (path, mtime, size): a reader
    called for every channel and window does not parse them again.  The
    `ChannelResponse` objects are shared between calls, read-only."""
    stamped = []
    for resp_dir in _resp_dirs(where):
        for path in sorted(glob.glob(os.path.join(resp_dir, "*.xml"))):
            st = os.stat(path)
            stamped.append((path, st.st_mtime_ns, st.st_size))
    return _parsed_inventory(tuple(stamped))


def data_reader_mseed(
    where,
    network="*",
    stations="*",
    channels="*",
    location="*",
    starttime=None,
    endtime=None,
    attach_response=False,
    data_folder="",
    **kwargs,
) -> Stream:
    """Tutorial-convention miniSEED reader.

    Folder layout as in BPMF/data_reader_examples.py:115-214:
    `where/<YYYY>/<JJJ>/data_folder/net.sta.loc.cha_*.mseed`.

    Uses obspy when it is installed (full format coverage + response
    attachment); otherwise the pure-NumPy miniSEED decoder (`data.mseed`:
    int16/int32/float32/float64/Steim1/Steim2), which decodes only the
    records in [starttime, endtime], and the StationXML parser
    (`data.stationxml`).
    """
    try:
        import obspy
    except ImportError:
        obspy = None

    t0 = np.datetime64(str(starttime).replace("Z", ""), "ns")
    year = t0.astype("datetime64[Y]")
    jday = int(
        (t0.astype("datetime64[D]") - year.astype("datetime64[D]"))
        / np.timedelta64(1, "D")
    ) + 1
    if not isinstance(stations, str):
        stations = ",".join(np.atleast_1d(stations))
    files = []
    for sta in stations.split(","):
        pattern = os.path.join(
            where, str(year), f"{jday:03d}", data_folder,
            f"{network}.{sta}.{location}.{channels}*",
        )
        files.extend(sorted(glob.glob(pattern)))

    if obspy is not None:
        st = obspy.Stream()
        for fn in files:
            st += obspy.read(
                fn,
                starttime=obspy.UTCDateTime(str(starttime)),
                endtime=obspy.UTCDateTime(str(endtime)),
            )
        st.merge(fill_value=0.0)
        if attach_response:
            invs = [
                obspy.read_inventory(fn)
                for resp_dir in _resp_dirs(where)
                for fn in sorted(glob.glob(os.path.join(resp_dir, "*.xml")))
            ]
            if not invs:
                # fail loudly: a silently response-less stream surfaces
                # much later as a confusing deconvolution failure
                raise FileNotFoundError(
                    f"attach_response: no StationXML found under "
                    f"{' or '.join(_resp_dirs(where))}"
                )
            st.attach_response(invs)
        return from_obspy(st)

    from .mseed import merge_fill, read_mseed

    out = Stream()
    for fn in files:
        out += read_mseed(fn, starttime=starttime, endtime=endtime)
    out = merge_fill(out)
    if attach_response:
        if _response_inventory(where).attach(out) == 0:
            raise FileNotFoundError(
                f"attach_response: no matching StationXML response under "
                f"{' or '.join(_resp_dirs(where))}"
            )
    return out


def data_reader_pyasdf(
    where,
    network="*",
    stations=None,
    channels=None,
    location="*",
    starttime=None,
    endtime=None,
    tag="raw_recording",
    **kwargs,
) -> Stream:
    """ASDF (pyasdf) reader (reference: BPMF/data_reader_examples.py:47-113)
    into the package's Stream.  Needs the optional `pyasdf` package,
    imported here."""
    try:
        import pyasdf
    except ImportError as e:
        raise ImportError(
            "data_reader_pyasdf requires pyasdf; use data_reader_hdf5 or "
            "data_reader_mseed instead"
        ) from e

    out = Stream()
    with pyasdf.ASDFDataSet(where, mode="r") as ds:
        for sta_code in ds.waveforms.list():
            sta = sta_code.split(".")[-1]
            if stations is not None and sta not in stations:
                continue
            st = getattr(ds.waveforms[sta_code], tag)
            out += from_obspy(st)
    if starttime is not None or endtime is not None:
        out = out.slice(starttime, endtime)
    return out
