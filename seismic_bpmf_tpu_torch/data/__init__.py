"""Host-side data model: streams, network/event/template containers, IO."""

from .catalog import Catalog
from .events import Event, Template
from .groups import EventGroup, Stack, TemplateGroup
from .network import Network
from .readers import (
    data_reader_hdf5, data_reader_mseed, data_reader_pyasdf,
    data_reader_template, write_hdf5_continuous,
)
from .stationxml import ChannelResponse, Inventory, read_inventory
from .stream import Stream, Trace
from .transform import WaveformTransform
from .travel_times import (
    SourceTable, TravelTimes, get_moveout_array, grid_travel_times,
    load_travel_times,
)
from .waveforms import Data, get_np_array

__all__ = [
    "Catalog",
    "ChannelResponse",
    "Data",
    "Event",
    "EventGroup",
    "Inventory",
    "Network",
    "SourceTable",
    "Stack",
    "Stream",
    "Template",
    "TemplateGroup",
    "Trace",
    "TravelTimes",
    "WaveformTransform",
    "data_reader_hdf5",
    "data_reader_mseed",
    "data_reader_pyasdf",
    "data_reader_template",
    "get_moveout_array",
    "get_np_array",
    "grid_travel_times",
    "load_travel_times",
    "read_inventory",
    "write_hdf5_continuous",
]
