"""Pure-Python StationXML (FDSN) instrument-response parsing.

Copy of `seismic_bpmf_tpu.data.stationxml` (numpy and the standard
library's ElementTree).  The reference attaches responses through obspy
(`read_inventory` + `Stream.attach_response` in
BPMF/data_reader_examples.py:178-189) and removes them with
`Trace.remove_response` (BPMF/spectrum.py:1600-1619).  This module parses
the subset of StationXML the physical-units chain needs: per-channel
poles/zeros stages and the overall instrument sensitivity, and evaluates
the evalresp-style transfer function.  The frequency-domain deconvolution
itself is `ops.response`.

Scope: analog PolesZeros stages (LAPLACE RADIANS/SECOND, LAPLACE HERTZ)
are combined multiplicatively; digital FIR/Coefficients stages are
treated as unity in the passband (their corrections are negligible below
the decimation corner, which is the regime the 2-12 Hz detection band and
the spectral fits live in).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ChannelResponse", "Inventory", "read_inventory"]


_UNIT_ORDER = {
    "M": 0, "M/S": 1, "M/S**2": 2, "M/SEC": 1, "M/SEC**2": 2,
    "M/S/S": 2, "NM": 0, "NM/S": 1, "NM/S**2": 2,
    "COUNTS": None, "COUNT": None, "V": None, "VOLTS": None, "A": None,
    "PA": None, "PASCALS": None, "T": None,
}

_OUTPUT_ORDER = {"DISP": 0, "VEL": 1, "ACC": 2}


@dataclasses.dataclass
class ChannelResponse:
    """One channel epoch's instrument response (counts per ground motion)."""

    network: str = ""
    station: str = ""
    location: str = ""
    channel: str = ""
    start_date: Optional[float] = None  # epoch seconds
    end_date: Optional[float] = None
    sensitivity: float = 1.0            # counts / input_units at freq below
    sensitivity_frequency: float = 1.0
    input_units: str = "M/S"
    poles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, complex)
    )
    zeros: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, complex)
    )
    normalization_factor: float = 1.0
    pz_in_hertz: bool = False           # LAPLACE (HERTZ) convention

    def transfer_function(self, freqs, output: str = "VEL") -> np.ndarray:
        """Complex H(f) such that ``counts(f) = H(f) * motion(f)`` with
        `motion` in the units selected by `output` ('DISP' m, 'VEL' m/s,
        'ACC' m/s^2).  evalresp convention: the poles/zeros factor is
        normalized by `normalization_factor` (A0) and scaled by the
        overall sensitivity."""
        f = np.asarray(freqs, float)
        s = (1j * f) if self.pz_in_hertz else (2j * np.pi * f)
        num = np.ones_like(s, dtype=complex)
        for z in self.zeros:
            num *= s - z
        den = np.ones_like(s, dtype=complex)
        for p in self.poles:
            den *= s - p
        with np.errstate(divide="ignore", invalid="ignore"):
            h = self.normalization_factor * num / den
        h[~np.isfinite(h)] = 0.0
        h *= self.sensitivity
        order_in = _UNIT_ORDER.get(self.input_units.upper())
        if order_in is None:
            raise ValueError(
                f"response input units {self.input_units!r} are not a "
                "ground-motion unit; cannot convert to "
                f"{output!r}"
            )
        n_diff = order_in - _OUTPUT_ORDER[output.upper()]
        if n_diff:
            iw = 2j * np.pi * f
            h = h * iw**n_diff
        if self.input_units.upper().startswith("NM"):
            h = h * 1e9  # counts per nm -> counts per m
        return h

    def covers(self, time: Optional[float]) -> bool:
        if time is None:
            return True
        if self.start_date is not None and time < self.start_date:
            return False
        if self.end_date is not None and time > self.end_date:
            return False
        return True


class Inventory:
    """A collection of `ChannelResponse` epochs with obspy-like lookup."""

    def __init__(self, responses: Optional[List[ChannelResponse]] = None):
        self.responses: List[ChannelResponse] = list(responses or [])

    def __len__(self) -> int:
        return len(self.responses)

    def __add__(self, other: "Inventory") -> "Inventory":
        return Inventory(self.responses + other.responses)

    def get_response(
        self,
        network: str = "",
        station: str = "",
        channel: str = "",
        location: str = "",
        time: Optional[float] = None,
    ) -> Optional[ChannelResponse]:
        """Best-match lookup (station+channel required; network/location
        matched when the inventory provides them)."""
        for r in self.responses:
            if r.station != station or r.channel != channel:
                continue
            if network and r.network and r.network != network:
                continue
            if location and r.location and r.location != location:
                continue
            if r.covers(time):
                return r
        return None

    def attach(self, stream) -> int:
        """Set ``tr.stats.response`` on every matching trace; returns the
        number of traces that got a response."""
        n = 0
        for tr in stream:
            r = self.get_response(
                tr.stats.network, tr.stats.station, tr.stats.channel,
                tr.stats.location, time=tr.stats.starttime,
            )
            if r is not None:
                tr.stats.response = r
                n += 1
        return n


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _childtext(el, name: str) -> Optional[str]:
    for c in el:
        if _local(c.tag) == name:
            return c.text
    return None


def _complexes(el, name: str) -> np.ndarray:
    out = []
    for c in el:
        if _local(c.tag) == name:
            re = im = 0.0
            for part in c:
                if _local(part.tag) == "Real":
                    re = float(part.text)
                elif _local(part.tag) == "Imaginary":
                    im = float(part.text)
            out.append(complex(re, im))
    return np.asarray(out, complex)


def _epoch(datestr: Optional[str]) -> Optional[float]:
    if not datestr:
        return None
    d = np.datetime64(datestr.rstrip("Z"), "ns")
    return float(d.astype(np.int64)) / 1e9


def _parse_response(resp_el) -> Tuple[float, float, str, List[dict]]:
    sens_val, sens_freq, units = 1.0, 1.0, "M/S"
    stages = []
    for c in resp_el:
        name = _local(c.tag)
        if name == "InstrumentSensitivity":
            v = _childtext(c, "Value")
            f = _childtext(c, "Frequency")
            sens_val = float(v) if v else 1.0
            sens_freq = float(f) if f else 1.0
            for part in c:
                if _local(part.tag) == "InputUnits":
                    u = _childtext(part, "Name")
                    if u:
                        units = u
        elif name == "Stage":
            for sub in c:
                if _local(sub.tag) == "PolesZeros":
                    tf_type = _childtext(sub, "PzTransferFunctionType") or ""
                    a0 = _childtext(sub, "NormalizationFactor")
                    stages.append(
                        {
                            "poles": _complexes(sub, "Pole"),
                            "zeros": _complexes(sub, "Zero"),
                            "a0": float(a0) if a0 else 1.0,
                            "hertz": "HERTZ" in tf_type.upper(),
                        }
                    )
    return sens_val, sens_freq, units, stages


def parse_stationxml(path: str) -> Inventory:
    """Parse one StationXML file into an `Inventory`."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    out: List[ChannelResponse] = []
    for net in root:
        if _local(net.tag) != "Network":
            continue
        net_code = net.get("code", "")
        for sta in net:
            if _local(sta.tag) != "Station":
                continue
            sta_code = sta.get("code", "")
            for cha in sta:
                if _local(cha.tag) != "Channel":
                    continue
                resp_el = None
                for c in cha:
                    if _local(c.tag) == "Response":
                        resp_el = c
                if resp_el is None:
                    continue
                sens, sfreq, units, stages = _parse_response(resp_el)
                if not stages:
                    stages = [
                        {"poles": np.zeros(0, complex),
                         "zeros": np.zeros(0, complex),
                         "a0": 1.0, "hertz": False}
                    ]
                # combine analog pz stages multiplicatively
                hertz = stages[0]["hertz"]
                if any(s["hertz"] != hertz for s in stages):
                    # mixed conventions: convert HERTZ stages to rad/s
                    for s in stages:
                        if s["hertz"]:
                            tp = 2.0 * np.pi
                            s["poles"] = s["poles"] * tp
                            s["zeros"] = s["zeros"] * tp
                            s["a0"] = s["a0"] * tp ** (
                                len(s["poles"]) - len(s["zeros"])
                            )
                            s["hertz"] = False
                    hertz = False
                out.append(
                    ChannelResponse(
                        network=net_code,
                        station=sta_code,
                        location=cha.get("locationCode", "") or "",
                        channel=cha.get("code", ""),
                        start_date=_epoch(cha.get("startDate")),
                        end_date=_epoch(cha.get("endDate")),
                        sensitivity=sens,
                        sensitivity_frequency=sfreq,
                        input_units=units,
                        poles=np.concatenate([s["poles"] for s in stages]),
                        zeros=np.concatenate([s["zeros"] for s in stages]),
                        normalization_factor=float(
                            np.prod([s["a0"] for s in stages])
                        ),
                        pz_in_hertz=hertz,
                    )
                )
    return Inventory(out)


def read_inventory(path_or_glob: str) -> Inventory:
    """Read one or many StationXML files (glob pattern) into a single
    `Inventory` (obspy `read_inventory` analogue)."""
    paths = sorted(glob.glob(path_or_glob))
    if not paths and os.path.exists(path_or_glob):
        paths = [path_or_glob]
    inv = Inventory()
    for p in paths:
        inv = inv + parse_stationxml(p)
    return inv
