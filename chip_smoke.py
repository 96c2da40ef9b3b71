"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: torch/CUDA versions, the card's name and power limit;
  2. build: compiles every kernel of seismic_bpmf_tpu_torch/csrc with nvcc;
  3. the fused MF kernel (f32-class: TF32-split operands, tensor cores;
     csrc/mf.cu: a pre-pass and a `wgmma` ring), its 'highest' build (the
     partials summed outside the tensor cores) and its default build
     ('default', 'screen'),
     against its plain PyTorch version on the card, at full bank width (128
     templates x 10 stations x 3 components, L = 200, moveouts in
     [-50, 400)) on a 2^17-sample window with a zero-filled gap, f32 gate
     rtol=1e-4, atol=1e-5; against the float64 oracle at sampled lags
     within 1e-5; step=2 and the fail-loud checks;
  4. the main path at full size: a two-day `scan_days(stage="mf")`
     campaign at the default 'screen' precision over 10 stations x 3
     components x 2,160,000 samples (25 Hz) with 128 templates of 8 s,
     built in memory from a seed; every re-injected repeat must be found
     at its sample index with CC >= 0.99, through the kernel only;
  5. exactness: one day at 'highest' through `matched_filter_day`, whose
     plans launch the 'highest' build only, each detection's CC within
     1e-6 of the float64 oracle `ops.reference.matched_filter_at` (and,
     checked after phase 11, closer than the `high` rung's); both builds'
     day against the plain version, their times, the pre-pass's time and
     their bound (three TF32 products on the tensor cores, beside the f32
     FMA figure);
  6. where a warm 'screen' day's time goes (host clock, torch.profiler);
  7. the BP kernel against its plain PyTorch version on the card at the
     BP configuration's width (100,000 lattice sources x 32 stations x 2
     phases, closest-10 weights, tools/lattice.py): reduce='max' on a
     2^14-sample window and 'none' on 2^12, both policies, values within
     rtol=1e-4, atol=1e-5, the argmax equal wherever the plain version's two
     best beams differ by more than 1e-5 (elsewhere the kernel's source has
     a plain beam within 1e-5 of the maximum), seeded exact ties to the
     smallest index, the 3-chunk call equal to the single call bit for bit,
     and the fail-loud checks; then every station weighted (64 rows a
     source tile, staged in more than one part) on a 2^13-sample window,
     and a plan with one moveout 40,000 samples from its tile's others
     (that station-phase staged as two rows) on 2^16; prints the seconds
     the day plan's tables take to build on the host;
  8. the BP main path at full size: a two-day `scan_days(stage="bp")`
     campaign over 32 stations x 3 components x 2,160,000 samples built
     in memory from a seed, with Hann bursts (P on Z, S on N/E) injected
     at the travel times of known lattice sources; every event must be
     found within 2 samples and one lattice spacing, through the kernel
     only; prints s/day of each stage and Gpoints/s;
  9. the BP kernel's numbers at day shape: ms per day (CUDA events, the
     day's chunk launches), the multiply-adds per word loaded from shared
     memory (counted from the plan's tables), its bound, the plain
     version's time, the values
     and the first-max rule held against the plain version; then
     where a warm BP day's time goes (stage timers, torch.profiler);
 10. the split MF kernel (the `high` rung: bf16-split operands, tensor
     cores) against its plain PyTorch version on phase 3's inputs, rtol=1e-4,
     atol=1e-5; against the float64 oracle at sampled lags within 5e-6;
     step=2; the fail-loud checks; and not bit-equal to the f32 kernel;
 11. this rung's main path at full size: a two-day
     `scan_days(stage="mf", precision="high")` over phase 4's world, through
     the split kernel only; every repeat found at its sample with CC >=
     0.99, every detection's CC within 5e-6 of the float64 oracle; then
     `assemble_catalog` over both days (the bank's inter-template CC
     computed on the card) with each repeat a `unique_event`;
 12. the campaign end to end on phase 8's world: one day
     `backproject_day` -> `build_templates` from its detections (an
     in-memory reader) -> `matched_filter_day(precision="high")` ->
     `assemble_catalog`, the scan through an explicit `high` engine; each
     of the three injected events is in the catalog once, at its time with
     CC >= 0.99, as the `unique_event` of its group of multiples (BP also
     triggers on an event's sidelobes, whose templates detect themselves
     a second or two away); then this plan (one ragged template tile x 96
     channels, wide moveout spans) is held to the plain version over the
     whole day, rtol=1e-4, atol=1e-5, and every detection's CC to the
     float64 oracle within 5e-6;
 13. the split kernel's numbers at day shape beside the f32-class kernel's
     on the same bank and day: ms per day (CUDA events), its bound, the
     plain version's time and the day-size compare with the plain version;
     the f32-class kernel's day held again to its plain version of phase 5;
 14. PhaseNet (seeded random weights, `init_phasenet`) on the card in f32
     against the same functions on the CPU in float64, on 4 stations x
     60,000 samples of phase 8's first day: `preprocess_batch` and
     `normalize_batch` within 1e-4 of the traces' maximum,
     `phasenet_probas_device` within 1e-5 (its forward scoped to IEEE f32
     while the global TF32 flag is on), the probabilities finite and
     summing to 1 within 1e-5;
 15. the PhaseNet BP day at full width on phase 8's world: day 1 through
     `preprocess_batch` (2-12 Hz) -> `phasenet_feature_fn` ->
     `backproject_day` on a `Beamformer` whose threshold is 4 deviations
     (random weights), twice, the second warm; each run
     launches kernel #3 11 times and its plain version never, the features
     (32, 2, 2,160,000) stay on the card, and both runs give the same
     detections (sample, source); the beam of a 100,000-sample cut of the
     day's features held to the plain version (rtol=1e-4, atol=1e-5, the
     first-max rule); the warm day's stage seconds with `bp_features`
     split into preprocess, normalize and forward, the device busy share
     (torch.profiler) and kernel #3's ms on these features against its
     bound;
 16. picks: `Event.pick_PS_phases(waveform_transform=...)` on up to 20 of
     phase 15's detections over a `WaveformTransform` of the day's
     probabilities (thresholds the probabilities' medians) equal to
     `find_picks` + `get_picks` on the same slices; three detections
     through the `picker=make_picker(model)` route, their tables' columns
     and dtypes checked; ms per event.
 17. kernel #3 against its plain version on the dense-array plan
     (`tools/dense_world.py`, scripts/dense_array.py's world: 1,000,000
     lattice sources x 128 stations x 2 phases, closest-20 weights) on a
     cut of the scan's envelopes around the first event: reduce='max' on
     2^12 samples under both policies and 'none' on 2^10, rtol=1e-4,
     atol=1e-5, the first-max rule; the plan tables' host seconds, the
     kernel's ms and its bound;
 18. the dense scan: `backproject_day` over the dense world (128 x 3 x
     540,000 samples, 21,600 s) through `Beamformer` on the card, twice
     (the second under torch.profiler); both injected events found within
     2 samples (of the origin plus the wavelet's envelope peak) and one
     lattice spacing, kernel launches counted and 0 plain calls, the same
     detections in both runs, stage seconds, Gpoints/s, the busy share, the
     peak device memory and the kernel's ms for the scan against its bound;
 19. relocation of the best detection on the same grid, as the script
     does: `relocate(routine="beam")` temporal on 80 s and spatial on 60 s
     (reduce='none', the argmax on the card, one beam column to the
     host), both within one lattice spacing of the injected node, the two
     hypocentres identical, the origin time within 2 s of the
     detection's, the uncertainties finite, an arrival-time table for
     every station with P_tt_sec > 0, one kernel launch each; NLLoc's obs
     and control files from the arrival times written and read back, and
     `relocate_nlloc` without a binary leaving the event un-relocated;
 20. the eikonal solver on the card: `build_travel_time_tables` for the
     128 stations, P and S, on a 101 x 101 x 31-node, 1 km grid of a
     layered model, 300 sweeps in f32; a homogeneous grid against straight
     rays (tests/test_eikonal.py's gates) and two stations' tables against
     float64 on the card within 1e-3 s; seconds, solves a second, peak
     device memory;
 21. the magnitude path (`tools/magnitude_world.py`: 10 stations x 3
     components at 100 Hz, 30 INT32 miniSEED files of 6 h, 10 StationXML,
     12 events of Mw 2.0-3.5): three windowed reads equal to a whole-file
     decode followed by `slice`; for every event on the card
     `extract_windows(attach_response=True)` through `data_reader_mseed`,
     `compute_moment_magnitude` and `approximate_moment_magnitude`, the fit
     within 0.25 of the injected Mw and Mw* within 0.3
     (tests/test_response.py's gates), the response FFT launched on the
     card at least 3 times an event; two events again with device="cpu"
     (windows within 1e-5 of their maximum, Mw and Mw* within 1e-3);
     `workflow.compute_magnitudes` over the 12 events; the world's
     seconds, each event's seconds by stage, events a second and the peak
     device memory;
 22. PhaseNet training (`tools/month_world.py`, the world of
     scripts/month_workflow.py, BASELINE config 3): the script's picker,
     256 windows of 3 x 3,001 samples, 6 epochs, batches of 32, lr 1e-3,
     sigma 10, from a seeded init; the first step on the card against the
     same step on the CPU (same weights, same batch): the loss within
     1e-5, every gradient within 1e-4 of the largest, the running
     statistics within 1e-4, the weights within 1e-6 of the difference
     Adam's first update makes of the two gradients; then
     `tools/month_workflow.train_picker` on the card, whose loss must
     fall; a checkpoint round trip (`save_variables` / `load_variables`)
     with bit-equal probabilities on the card; ms a step, windows/s, the
     phase's own peak device memory;
 23. the month chain at full width over 3 days (10 stations x 3 x
     2,160,000 samples a day, 10,000 sources): `bp_campaign` (the trained
     picker's probabilities, `scan_days(stage="bp")`) over days 0-1, then
     over days 0-2 from the same state file, which must run day 2 only;
     the bank from day 0 (`build_templates`), `mf_campaign` at 'screen'
     over the 3 days, `assemble_catalog`; kernel #3 on every BP day and
     kernel #1's default build on every MF day, with no plain call; every
     detection's CC within 1e-6 of the float64 oracle; on every day both
     injected events at their samples through each template the bank kept
     at an injected event, at CC >= 0.99 where the template is cut at that
     event (the other event is held to the oracle: the script's float32
     injection puts 3 of its 30 channels one sample off); each event once
     a `unique_event` in the catalog; then kernel #3 on the campaign's own
     `Beamformer` plan and a 100,000-sample cut of day 2's trained-picker
     features held to its plain version (first-max rule), and kernel #1's
     default build on the MF campaign's own plan and day 2 as 'screen'
     uploads it (bf16-rounded, the whole day) held to its plain version;
     s/day of both stages beside the world's draw and load seconds (the
     days are drawn into a temporary folder once and loaded after, as the
     script's HDF5 days are), the bank, the detection counts, a warm BP
     day's device busy share;
 24. the year bank, BASELINE config 4 (`tools/year_world.py`,
     scripts/year_scan.py's world: 10 stations x 3 components x 2,160,000
     samples a day, two injected events, 1024 tid-distinct copies of the
     two events' templates) at 'screen' through `tools/year_scan.campaign`
     (`scan_days` with the script's arguments and a state file) over days
     0-1, then over days 0-2 from the same state file, which must run day
     2 only; kernel #1's default build on every day with no plain call,
     the bank's plans built once for two days; every template detects
     both events every day within a sample, the template ids cover
     0-1023, and day 0's detections (template, sample, CC) equal those of
     the four 256-template sub-banks scanned alone and of a run whose
     `max_memory_gb` puts the extraction cut at 512; kernel #1's default
     build on day 2's upload through the year plan's first chunk (a 2^17
     cut around the first event) held to its plain version (rtol=1e-4,
     atol=1e-5); the extraction chunk, s/day, CC GSamples/s, the prefetch
     thread's `set_data` seconds, the refine and Event seconds, the peak
     device memory, kernel #1's ms a day at 1024 templates, a warm day's
     device busy share;
 25. the family path: phase 23's MF detections of the template with the
     most (at least 3) -> `EventGroup.read_waveforms` through the month
     world's reader -> `get_waveforms_arr` -> `normalize("rms")` ->
     `SVDWF_stack` (every panel in one batched float64 SVD on the card,
     counted; the card's stacks within 1e-9 of their maximum against the
     host float64 version on the family's own panels) ->
     `Stack.read_waveforms` -> `pick_PS_phases_family_mode` with phase
     22's trained picker on the card, the family's picks within
     `FAMILY_PICK_TOL` samples of the injected arrivals at
     `FAMILY_MIN_STATIONS` stations or more for each phase; ms a family.
 26. the sharded MF day (`parallel`, ROADMAP Queue 1 #19): phase 4's bank
     and day 1 through both designs of kernel #1 and kernel #2, one launch
     per (template shard, time shard) of two virtual meshes of the card,
     {"tp": 2, "time": 4} and the ragged {"tp": 3, "time": 5}; every
     rung's day equal to the unsharded kernel's bit for bit, and the 2 x 4
     mesh's last time shard of template shard 1 (its lag bounds moved by
     its base, the day's end) held to the rung's plain version (rtol=1e-4,
     atol=1e-5); launches, the day's ms sharded and unsharded, each
     shard's ms, the halo copies' ms; then `scan_days(stage="mf",
     mesh=...)` over phase 4's two days at 'screen' on both meshes, the
     detections (template, sample) identical to phase 4's, kernel #1's
     default build only, s/day beside phase 4's, the peak device memory;
 27. the sharded BP day: kernel #3 per (source shard, time shard) of
     {"src": 2, "time": 4} and {"src": 3, "time": 5} on phase 8's world
     (day 1's envelopes), each time shard holding its own columns and a
     halo from its absolute origin; (max, argmax) equal to the unsharded
     kernel's bit for bit, the day's last tiles of one shard held to the
     plain version (first-max rule), a source of the last source shard
     made an exact copy of one of the first (a spike at their moveouts on
     a 2^17 cut): the smaller index wins; reduce='none' on 3,000 sources x
     2^14 samples equal to the unsharded beam; `scan_days(stage="bp",
     mesh=...)` over day 1 on both meshes with phase 8's detections
     (sample, source); launches, ms, each shard's ms, the halos' ms, s/day
     by stage, the peak device memory.
 28. the command line: `python -m seismic_bpmf_tpu_torch info` as a
     subprocess (backend cuda, the card named), then the CLI's runners on
     the in-memory worlds (this machine has no h5py for the file loaders):
     `run_backproject` on phase 8's day 1 (kernel #3, the detections
     (sample, source) of phase 8's day 1), `run_matched_filter --precision
     high` on phase 4's bank and day 1 (kernel #2 only; every day-1 repeat
     at its sample with CC >= 0.99), `run_scan` over phase 4's two days at
     'screen' with a state file (kernel #1's default build only; every
     repeat), its resume (0 days, no launch), `run_catalog` on the scan's
     detections (the CSV read back by `Catalog.read`, every repeat one
     unique event); each runner's seconds beside phases 4, 8 and 11;
 29. `train_phasenet(mesh=)` on virtual meshes of the card, {"data": 4} and
     {"data": 3}: the first sharded step (batches of 32 and 30) against
     the unsharded step on the card within phase 22's gates, then phase
     22's training (256 windows x 6 epochs) on the 4-shard mesh, each
     epoch's loss within 1e-3 relative of phase 22's; ms a step; a warm
     step of 32 unsharded and on 4 shards (one CUDA graph over the shards'
     forward and backward): its ms and launches (torch.profiler);
 30. `utils.observe.profile_trace` around a warm 'screen' day at phase 4's
     shape in a fresh process (its one Chrome trace holds kernel #1's row)
     and in this one on phase 4's bank and day 1 (the device rows counted:
     a process that has kept the card busy for minutes loses some); `examples/synthetic_day_torch.py` as a subprocess,
     ending in "OK: all injected events recovered";
 31. the port's benchmark program in fresh processes:
     `python3 -m seismic_bpmf_tpu_torch bench --check` (every parity rung
     of kernels #1 (both designs), #2 and #3), `python3 bench_torch.py`
     (the parity gate, the `high` headline and its four extras, written
     to a temporary file), `bench_torch.py --bp --budget-s 20` and
     `bench_torch.py --phasenet`; each must exit 0 with a JSON line last
     whose value is above 0, and each extra must hold a value above 0;
     the four lines and the bench's `#` lines are printed, its stderr goes
     to chiprun_out/chip_smoke_bench.txt.
 32. the native host scans (`ops.host_ops`: the package's copy of the C++
     host runtime, built here by the C++ compiler) bit for bit against
     their NumPy versions: `select_cc_indexes` and
     `dedup_detection_indexes` on one template's whole 'screen' day of CC
     (phase 4's day 1, kernel #1's default build) with its RMS threshold,
     and the margin and search window of `MatchedFilter.select_cc_indexes`
     (MF's host route); `flag_multiples` on phase 23's catalog with its
     bank's distance and CC tables; `find_similar_sources` on phase 8's
     100,000 lattice sources (64 station-phase moveouts in samples, 10 x
     10 cells, the 10 smallest differences), and with `method='closest'`
     (the 10 closest stations) on the first 10,000 with the ties at the
     10th moveout broken by station index, the sources where the tied
     moveouts as they are give other marks counted; each scan's native
     and NumPy ms.  Of the four, MF's host route calls
     `dedup_detection_indexes` (as in the JAX package); the other three
     are the JAX module's API, bound for it and called by no path.
It then prints the card line, one JSON line of per-kernel numbers (kernel
#3's launches those of phases 8, 18, 19, 23, 27 and 28; kernel #1's
default build's those of phases 4, 23, 24, 26 and 28; kernel #2's those of
phases 11 and 28), and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(1)
T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from seismic_bpmf_tpu_torch import _build  # noqa: E402
from seismic_bpmf_tpu_torch import cli, workflow  # noqa: E402
from seismic_bpmf_tpu_torch.config import Config  # noqa: E402
from seismic_bpmf_tpu_torch.data import (  # noqa: E402
    Catalog, EventGroup, Stream, TemplateGroup, Trace, WaveformTransform,
)
from seismic_bpmf_tpu_torch.detection import (  # noqa: E402
    Beamformer, MatchedFilter,
)
from seismic_bpmf_tpu_torch.models import (  # noqa: E402
    PhaseNet, init_phasenet, load_variables, make_picker,
    make_sharded_train_step, make_train_step, phasenet_probas_device,
    save_variables, train_phasenet,
)
from seismic_bpmf_tpu_torch.models.phasenet import (  # noqa: E402
    _ieee_convolutions, cross_entropy_loss, gaussian_pick_labels,
    init_weights,
)
from seismic_bpmf_tpu_torch.location import (  # noqa: E402
    build_travel_time_tables, layered_velocity_grid, relocate_nlloc,
    write_nlloc_control, write_nlloc_obs,
)
from seismic_bpmf_tpu_torch.location.eikonal import (  # noqa: E402
    solves_per_batch as eikonal_batch, travel_time_grid as eikonal_grid,
    travel_time_grids as eikonal_grids,
)
from seismic_bpmf_tpu_torch.ops import bp, host_ops, mf  # noqa: E402
from seismic_bpmf_tpu_torch.ops.beamform import (  # noqa: E402
    _flatten_moveouts, fold_components,
)
from seismic_bpmf_tpu_torch.ops.cf import saturated_envelopes  # noqa: E402
from seismic_bpmf_tpu_torch.ops.picks import (  # noqa: E402
    PickTable, candidates, find_picks, get_picks, normalize_batch,
)
from seismic_bpmf_tpu_torch.ops.reference import matched_filter_at  # noqa: E402
from seismic_bpmf_tpu_torch.ops.signal import preprocess_batch  # noqa: E402
from seismic_bpmf_tpu_torch.ops.thresholds import (  # noqa: E402
    time_dependent_threshold,
)
from seismic_bpmf_tpu_torch.parallel import make_mesh, sharded  # noqa: E402
from seismic_bpmf_tpu_torch.ops import response  # noqa: E402
from seismic_bpmf_tpu_torch.data import data_reader_mseed  # noqa: E402
from seismic_bpmf_tpu_torch.data.mseed import read_mseed  # noqa: E402
from seismic_bpmf_tpu_torch.source import (  # noqa: E402
    Spectrum, approximate_moment_magnitude, compute_moment_magnitude,
    extract_windows,
)
from seismic_bpmf_tpu_torch.tools.magnitude_world import (  # noqa: E402
    build_world as build_magnitude_world,
)
from seismic_bpmf_tpu_torch.tools.mesh_days import (  # noqa: E402
    step_profile, wall_ms,
)
from seismic_bpmf_tpu_torch.tools.month_world import (  # noqa: E402
    build_world as build_month_world, training_windows,
)
from seismic_bpmf_tpu_torch.tools.month_workflow import (  # noqa: E402
    TRAIN_KW as MONTH_TRAIN, bp_campaign, bp_day, catalog_of, dates_of,
    mf_campaign, template_bank, train_picker,
)
from seismic_bpmf_tpu_torch.tools.year_scan import (  # noqa: E402
    campaign as year_campaign, dates_of as year_dates,
)
from seismic_bpmf_tpu_torch.tools.year_world import (  # noqa: E402
    build_bank as build_year_bank, build_world as build_year_world,
)
from seismic_bpmf_tpu_torch.utils import stacking  # noqa: E402
from seismic_bpmf_tpu_torch.tools.dense_world import (  # noqa: E402
    KM_PER_DEG as KM_PER_DEG_DENSE, build_world as build_dense_world,
)
from seismic_bpmf_tpu_torch.tools.bp_world import (  # noqa: E402
    BP_EVENTS, BPWorld,
)
from seismic_bpmf_tpu_torch.tools.lattice import KM_PER_DEG  # noqa: E402
from seismic_bpmf_tpu_torch.tools.mf_world import (  # noqa: E402
    DATES, L, MFWorld, N_COMP, N_STA, REPEATS, SR, T0_EPOCH,
)
from seismic_bpmf_tpu_torch.utils.geo import two_point_distance  # noqa: E402
from seismic_bpmf_tpu_torch.utils.observe import (  # noqa: E402
    BF16_PEAK_FLOPS, GLOBAL_TIMER, TF32_PEAK_FLOPS, bp_bound_ms,
    mf_bound_ms, profile_trace,
)
from seismic_bpmf_tpu_torch.utils.time import utc_from_epoch  # noqa: E402

SEED = 20260816
N_TP = 128
DAY_SEC = 86400.0
N_SAMP = int(DAY_SEC * SR)          # 2,160,000
ATOL_HIGH = 5e-6                    # the `high` rung against the oracle
ATOL_HIGHEST = 1e-6                 # the `highest` rung against the oracle
RTOL, ATOL = 1e-4, 1e-5
DENSE_CLOSEST = 20                  # scripts/dense_array.py's --closest
N_YEAR = 1024                       # scripts/year_scan.py's --templates
YEAR_DAY_KW = dict(minimum_interevent_time=5.0, threshold_window_dur=1800.0)
FAMILY_WIN = 20.0                   # s of each member stacked
FAMILY_OFFSETS = {"P": 2.0, "S": 4.0}
FAMILY_PICK_SEC = 120.0             # the picker's window (3,001 samples)
FAMILY_OFFSET_OT = 20.0
FAMILY_THRESHOLD = 0.3
# |family pick - injected arrival| in samples, and the stations (of 10)
# that must meet it, set by CPU runs of this phase (a cut of the month world,
# and the full world with members 0.6, -0.4 and 1.5 s from the events):
# the trained picker's P probabilities peak at 0.4-0.5, 5-27 samples after
# the onset at most stations (8-10 of 10 within 30); its S picks lie within
# 10 samples at 5-10 stations, the rest on other arrivals
FAMILY_PICK_TOL = {"P": 30.0, "S": 10.0}
FAMILY_MIN_STATIONS = {"P": 7, "S": 4}
EIK_SHAPE = (101, 101, 31)          # the dense box's eikonal grid, 1 km

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def plain_of(plan, data_pad):
    kw = dict(n_tp=plan.n_tp, L=plan.L, n_corr=plan.n_corr_unit,
              lo_p=plan.lo_p, hi_p=plan.hi_p)
    if plan.precision_name == "high":
        return mf.matched_filter_split_plain(
            data_pad, *mf.split_rows_parts(plan.filt_rows, plan.L),
            plan.mv_table, **kw)
    return mf.matched_filter_plain(
        data_pad, *mf.tf32_rows_parts(plan.filt_rows, plan.L), plan.mv_table,
        **kw)


def device_profile(prof, name: str) -> tuple:
    """(device busy ms, the top kernels as text) of a torch.profiler run,
    from its device-side rows only (a CPU op's own device time repeats its
    kernels'); the whole table goes to chiprun_out/<name>."""
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.self_device_time_total, reverse=True)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(f"{CARD}\n")
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=25))
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms "
                    f"x{e.count}" for e in rows[:6])
    return sum(e.self_device_time_total for e in rows) / 1e3, top


def zero_counts():
    """Every kernel's launch count and plain version's call count to 0,
    just before a main path is driven."""
    mf.mf_cc.launches = mf.matched_filter_plain.calls = 0
    mf.mf_cc_highest.launches = 0
    mf.mf_cc_split.launches = mf.matched_filter_split_plain.calls = 0
    mf.split_day.launches = mf.tf32_day.launches = 0
    bp.bp_beam.launches = bp.beamform_plain.calls = 0
    response.apply_spectral_filter.launches = 0
    stacking.svdwf_panels.launches = 0


def timed(fn, seconds: dict, key: str):
    """`fn`, adding the host seconds of each call to seconds[key]."""
    def call(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[key] += time.perf_counter() - t
    return call


# --------------------------------------------------------------------------
# 1. environment
print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
      f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}",
      flush=True)
CARD = gpu_line()
print(f"card: {CARD}", flush=True)

# 2. build
t0 = time.perf_counter()
built = _build.build_all()
print(f"build: {built} ({time.perf_counter() - t0:.2f} s)", flush=True)

# 3. kernel against its plain version at full bank width
rng = np.random.default_rng(SEED)
n_win = 2**17
tpl = rng.normal(size=(N_TP, N_STA, N_COMP, L)).astype(np.float32)
mv = rng.integers(-50, 400, size=(N_TP, N_STA, N_COMP))
wts = np.full((N_TP, N_STA, N_COMP), 1.0 / (N_STA * N_COMP), np.float32)
wts[0, 0] = 0.0                      # zero-weight channels add nothing
tpl[1, 1, 1] = 3.0                   # a zero-norm template channel
win = rng.normal(size=(N_STA, N_COMP, n_win)).astype(np.float32)
win[:, :, 40000:50000] = 0.0         # a zero-filled gap
plan3 = mf.MatchedFilterPlan(tpl, mv, wts, n_win, precision="highest")
dp3 = plan3.pad_data(win)
got = plan3(dp3)
ref = plain_of(plan3, dp3)
call3 = dict(n_tp=plan3.n_tp, L=L, n_corr=plan3.n_corr_unit,
             lo_p=plan3.lo_p, hi_p=plan3.hi_p, max_delta=plan3.max_delta)
got3d = mf.mf_cc(dp3, plan3.filt_rows, plan3.mv_table, plan3.tile_lo,
                 **call3)
torch.cuda.synchronize()
err3 = float((got - ref).abs().max())
err3d = float((got3d - ref).abs().max())
if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"kernel != plain version: max|diff| {err3:.3g}")
if not torch.allclose(got3d, ref, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"default build != plain version: max|diff| "
                         f"{err3d:.3g}")
for what, cc in (("highest", got), ("default", got3d)):
    if float(cc[:, 40050:49400].abs().max()) != 0.0:
        raise AssertionError(f"{what}: the zero-filled gap does not give "
                             f"CC = 0")
del got3d
lags3 = rng.integers(0, n_win - L, size=64)
lags3[:4] = (0, n_win - L, 39990, 50003)        # the edges, the gap's rim
worst3 = 0.0
for t3 in (0, 1, N_TP // 2, N_TP - 1):
    exact = matched_filter_at(tpl[t3], mv[t3], wts[t3], win, lags3)
    worst3 = max(worst3, float(np.abs(
        exact - got[t3, lags3].cpu().numpy()).max()))
if worst3 > ATOL:
    raise AssertionError(f"kernel: max|CC - oracle| {worst3:.3g}")
got2 = mf.matched_filter(tpl, mv, wts, win, step=2)
if not torch.allclose(got2, ref[:, ::2][:, : (n_win - L) // 2 + 1],
                      rtol=RTOL, atol=ATOL):
    raise AssertionError("step=2 disagrees with the decimated scan")
for bad in (dict(pad_left=10), dict(max_moveout=100)):
    try:
        mf.MatchedFilterPlan(tpl, mv, wts, n_win, **bad)
    except ValueError:
        continue
    raise AssertionError(f"plan override {bad} did not fail loud")
try:
    plan3(dp3.double())
except ValueError:
    pass
else:
    raise AssertionError("a float64 day reached the kernel")
ms3 = cuda_ms(lambda: plan3(dp3), 5)
t0 = time.perf_counter()
plain_of(plan3, dp3)
torch.cuda.synchronize()
plain3 = 1e3 * (time.perf_counter() - t0)
print(f"kernel vs plain (128 x 30 x L=200, 2^17 samples): max|diff| "
      f"{err3:.3g}, default build {err3d:.3g} (rtol={RTOL}, atol={ATOL}), "
      f"max|CC - oracle| "
      f"{worst3:.3g} at {4 * len(lags3)} lags (atol={ATOL}); kernel "
      f"{ms3:.3f} ms, plain {plain3:.1f} ms [{CARD}]", flush=True)


# 4. the main path at full size (the world: tools/mf_world.py)
t0 = time.perf_counter()
W4 = MFWorld(SEED, n_tp=N_TP, day_sec=DAY_SEC, repeats=REPEATS)
mv_w, wave, origins, DAYS = W4.mv, W4.wave, W4.origins, W4.days
make_day, memory_reader, make_data = W4.make_day, W4.reader, W4.make_data
d1 = W4.day("d1")
templates, tg = W4.bank()
stations = W4.stations
print(f"world: {N_TP} templates x {N_STA * N_COMP} channels x {N_SAMP} "
      f"samples ({time.perf_counter() - t0:.1f} s)", flush=True)

cfg = Config(sampling_rate_hz=SR, template_len_sec=L / SR)
kw = dict(minimum_interevent_time=5.0, min_channels=6, min_stations=3,
          max_kurto=1e6, rng=np.random.default_rng(SEED + 2))
zero_counts()
t0 = time.perf_counter()
results = workflow.scan_days(list(DATES), make_data, tg, cfg=cfg, **kw)
wall = time.perf_counter() - t0
launches = mf.mf_cc.launches
plain_calls = mf.matched_filter_plain.calls
if (launches < 1 or plain_calls != 0 or mf.mf_cc_highest.launches
        or mf.tf32_day.launches != launches):
    raise AssertionError(f"main path: {launches} kernel launches, "
                         f"{mf.tf32_day.launches} of its pre-pass, "
                         f"{plain_calls} plain-version calls, "
                         f"{mf.mf_cc_highest.launches} of the highest build")
for day, tid, o in REPEATS:
    t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
    hits = [e for e in results[day][str(tid)]
            if abs(e.origin_time_epoch - t_exp) < 0.5 / SR]
    if not hits or hits[0].aux_data["cc"] < 0.99:
        raise AssertionError(f"repeat of template {tid} at sample {o} of "
                             f"{day} not detected with CC >= 0.99: {hits}")
n_det = {d: sum(len(v) for v in r.values()) for d, r in results.items()}
scan_s = GLOBAL_TIMER.times["mf_scan"] / len(DATES)
macs_day = N_TP * N_STA * N_COMP * L * (N_SAMP - L + 1)
print(f"scan_days screen: {n_det} detections, every repeat found; "
      f"{scan_s:.3f} s/day matched_filter_day, {macs_day / scan_s / 1e9:.0f} "
      f"GMAC/s end to end, campaign wall {wall:.1f} s; kernel launches "
      f"{launches} [{CARD}]", flush=True)

# 5. exactness at 'highest', and the kernel's numbers at main-path shapes
engine = MatchedFilter(tg, cfg=cfg, precision="highest",
                       **{k: v for k, v in kw.items()
                          if k != "minimum_interevent_time"})
day1 = make_data("d1")
zero_counts()
dets = workflow.matched_filter_day(tg, day1, cfg=cfg, mf=engine,
                                   minimum_interevent_time=5.0)
launches5 = mf.mf_cc_highest.launches
others5 = (mf.mf_cc.launches, mf.matched_filter_plain.calls)
if launches5 < 1 or others5 != (0, 0):
    raise AssertionError(f"highest: {launches5} launches of its build; "
                         f"default build, plain: {others5}")
worst, n_checked = 0.0, 0
for tid, evs in dets.items():
    tt = int(tg.tindexes[tid])
    for e in evs:
        idx = int(round((e.origin_time_epoch - day1.date_epoch) * SR))
        exact = matched_filter_at(tg.waveforms_arr[tt], tg.moveouts_arr[tt],
                                  engine.weights_channels[tt],
                                  engine.data_arr, np.array([idx]))[0]
        worst = max(worst, abs(float(exact) - e.aux_data["cc"]))
        n_checked += 1
if n_checked < N_TP or worst > ATOL_HIGHEST:
    raise AssertionError(f"highest: {n_checked} detections, max|CC - "
                         f"oracle| {worst:.3g}")
print(f"highest: {n_checked} detections within {worst:.3g} of the float64 "
      f"oracle (atol={ATOL_HIGHEST}); launches of its build {launches5}",
      flush=True)

plan = next(iter(engine._plans.values()))[0]
dp = engine._data_pad
bound_ms, bound_by, macs, fma_ms = mf_bound_ms(plan, dp)
got = plan(dp)
t0 = time.perf_counter()
ref = plain_of(plan, dp)
torch.cuda.synchronize()
plain_ms = 1e3 * (time.perf_counter() - t0)
err = float((got - ref).abs().max())
if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"day-size kernel != plain: max|diff| {err:.3g}")
# the default build ('default', 'screen') on the same plan and day
call5 = dict(n_tp=plan.n_tp, L=L, n_corr=plan.n_corr_unit, lo_p=plan.lo_p,
             hi_p=plan.hi_p, max_delta=plan.max_delta)


def default5():
    return mf.mf_cc(dp, plan.filt_rows, plan.mv_table, plan.tile_lo, **call5)


got5d = default5()
torch.cuda.synchronize()
err5d = float((got5d - ref).abs().max())
if not torch.allclose(got5d, ref, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"day-size default build != plain: max|diff| "
                         f"{err5d:.3g}")
builds5 = float((got5d - got).abs().max())
ref5 = ref                  # held against the kernel again in phase 13
del got, ref, got5d
ms = cuda_ms(lambda: plan(dp), 5)
ms5d = cuda_ms(default5, 5)
pre5 = cuda_ms(lambda: mf.tf32_day(dp, L), 5)
print(f"mf kernel, one day: highest build (csrc/mf.cu) {ms:.2f} ms "
      f"({macs / ms / 1e6:.0f} GMAC/s; max|CC - oracle| {worst:.3g} at its "
      f"{n_checked} detections), default build {ms5d:.2f} ms "
      f"({ms / ms5d:.3f} of it; the pre-pass of each {pre5:.3f} ms), "
      f"bound {bound_ms:.2f} ms ({bound_by}: 3 TF32 products at "
      f"{TF32_PEAK_FLOPS / 1e12:.0f} TFLOP/s; the f32 FMA figure "
      f"{fma_ms:.2f} ms), plain {plain_ms:.0f} ms; max|diff| from plain "
      f"{err:.3g}, default build {err5d:.3g}, between the builds "
      f"{builds5:.3g} [{CARD}]", flush=True)


# 6. where a warm 'screen' day's time goes: the host clock around each step
#    of `matched_filter_day`, then torch.profiler over one whole day
screen = MatchedFilter(tg, cfg=cfg, precision="screen",
                       **{k: v for k, v in kw.items()
                          if k != "minimum_interevent_time"})
workflow.matched_filter_day(tg, day1, cfg=cfg, mf=screen,
                            minimum_interevent_time=5.0)   # plans, warm-up
steps = {}
torch.cuda.synchronize()
t_day = time.perf_counter()
for name, step in (
        ("set_data", lambda: screen.set_data(day1)),
        ("weights", lambda: screen.set_weights_channels(method="simple",
                                                        normalize=True)),
        ("search", lambda: screen.run_matched_filter_search(5.0,
                                                            verbose=-1))):
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t0
warm_s = time.perf_counter() - t_day
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    workflow.matched_filter_day(tg, day1, cfg=cfg, mf=screen,
                                minimum_interevent_time=5.0)
    torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
busy_ms, top = device_profile(prof, "chip_smoke_profile.txt")
print(f"warm screen day: {warm_s:.3f} s ({macs_day / warm_s / 1e9:.0f} "
      f"GMAC/s): " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
      + f"; profiled day {prof_s:.3f} s, device busy {busy_ms:.1f} ms "
      f"({100 * busy_ms / (1e3 * prof_s):.0f}%): {top} [{CARD}]",
      flush=True)


# 7. the BP kernel against its plain version at the main path's width
def check_first_max(tab, g_pad, kv, ki, pv, pi, what: str) -> int:
    """Hold a 'max' result (kv, ki) to the plain version's (pv, pi): values
    within RTOL/ATOL, and wherever the indices differ the kernel's source
    has a plain beam within ATOL of the plain maximum (so the two best
    beams there differ by no more than ATOL).  Returns that count."""
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"bp kernel != plain ({what}): max|diff| "
                             f"{float((kv - pv).abs().max()):.3g}")
    t = torch.nonzero(ki != pi).flatten()
    if t.numel():
        src = ki[t].long()
        at_k = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for sp in range(tab.n_sp):      # as beamform_plain sums
            at_k = at_k + tab.w[sp, src] * g_pad[sp, t + tab.mv[sp, src]]
        if tab.strict:
            ok = (t + tab.lo[src] >= 0) & (t + tab.hi[src] < tab.n_samp)
            at_k = torch.where(ok, at_k, torch.zeros_like(at_k))
        if bool((at_k < pv[t] - ATOL).any()):
            raise AssertionError(f"bp kernel argmax breaks the first-max "
                                 f"rule ({what})")
    return int(t.numel())


N_SRC_BP, N_STA_BP = 100_000, 32
W7 = BPWorld(SEED, n_src=N_SRC_BP, n_sta=N_STA_BP, day_sec=DAY_SEC,
             events=BP_EVENTS)
src_km, sta_km, spacing, tt_bp = W7.src_km, W7.sta_km, W7.spacing, W7.tt
mv_bp, w_src_bp, w_ph_bp = W7.mv, W7.w_src, W7.w_ph
# seeded exact ties: later copies of the sources that a spike makes best
brng = np.random.default_rng(SEED + 3)
tie_src = brng.choice(N_SRC_BP // 2, size=4, replace=False)
tie_copy = tie_src + N_SRC_BP // 2
mv_bp7, w_src_bp7 = mv_bp.copy(), w_src_bp.copy()
mv_bp7[tie_copy], w_src_bp7[tie_copy] = mv_bp[tie_src], w_src_bp[tie_src]
errs_bp = []
t0 = time.perf_counter()
for oob in ("strict", "flexible"):
    n7 = 2**14
    feat7 = brng.uniform(0, 1, size=(N_STA_BP, 3, n7)).astype(np.float32)
    for j, i in enumerate(tie_src):                # a spike for source i
        for s in np.flatnonzero(w_src_bp[i]):
            feat7[s, 2, 3000 + 2000 * j + mv_bp[i, s, 0]] += 50.0
            feat7[s, :2, 3000 + 2000 * j + mv_bp[i, s, 1]] += 50.0
    plan7 = bp.BeamformPlan(mv_bp7, w_ph_bp, w_src_bp7, n7,
                            out_of_bounds=oob)
    g7 = plan7.fold_and_pad(feat7)
    kv, ki = plan7.call_folded(g7)
    pv, pi = bp.beamform_plain(g7, plan7.tables)
    none7 = bp.BeamformPlan(mv_bp7, w_ph_bp, w_src_bp7, n7, reduce="none",
                            out_of_bounds=oob)
    full = bp.beamform_plain(none7.fold_and_pad(feat7), none7.tables,
                             reduce="none")
    top2 = torch.topk(full, 2, dim=0).values
    at_k = full.gather(0, ki[None].long())[0]
    del full
    torch.cuda.synchronize()
    pv, pi = pv[:n7], pi[:n7]
    errs_bp.append(float((kv - pv).abs().max()))
    if not torch.allclose(kv, pv, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"bp kernel != plain ({oob}, max): max|diff| "
                             f"{errs_bp[-1]:.3g}")
    clear = (top2[0] - top2[1]) > ATOL
    if (not torch.equal(ki[clear], pi[clear])
            or bool((at_k < top2[0] - ATOL).any())):
        raise AssertionError(f"bp kernel argmax breaks the first-max rule "
                             f"({oob})")
    for j, i in enumerate(tie_src):
        t_sp = 3000 + 2000 * j
        if int(ki[t_sp]) != i or int(pi[t_sp]) != i:
            raise AssertionError(f"tie at sample {t_sp}: kernel "
                                 f"{int(ki[t_sp])}, plain {int(pi[t_sp])}, "
                                 f"want the smaller copy {i}")
    if bool(torch.isin(ki, torch.from_numpy(tie_copy.astype(np.int32))
                       .to(ki.device)).any()):
        raise AssertionError("a later exact copy won a tie")
    cv, ci = plan7.call_folded_chunked(g7, 3)
    if not (torch.equal(cv, kv) and torch.equal(ci, ki)):
        raise AssertionError(f"3-chunk call != single call ({oob})")
    n7n = 2**12
    none7 = bp.BeamformPlan(mv_bp7, w_ph_bp, w_src_bp7, n7n, reduce="none",
                            out_of_bounds=oob)
    g7n = none7.fold_and_pad(feat7[..., :n7n])
    kb = none7.call_folded(g7n)
    pb = bp.beamform_plain(g7n, none7.tables, reduce="none")
    torch.cuda.synchronize()
    errs_bp.append(float((kb - pb).abs().max()))
    if not torch.allclose(kb, pb, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"bp kernel != plain ({oob}, none): max|diff| "
                             f"{errs_bp[-1]:.3g}")
    del kb, pb
# every station weighted: a source tile's 64 rows are staged in parts
n7a = 2**13
w_all = np.full((N_SRC_BP, N_STA_BP), 1.0 / N_STA_BP, np.float32)
plan7a = bp.BeamformPlan(mv_bp, w_ph_bp, w_all, n7a)
if plan7a.tables.n_stages <= plan7a.tables.n_tiles:
    raise AssertionError("every station weighted: no tile took two stages")
g7a = plan7a.fold_and_pad(brng.uniform(0, 1, size=(N_STA_BP, 3, n7a))
                          .astype(np.float32))
kv, ki = plan7a.call_folded(g7a)
pv, pi = bp.beamform_plain(g7a, plan7a.tables)
errs_bp.append(float((kv - pv[:n7a]).abs().max()))
near7a = check_first_max(plan7a.tables, g7a, kv, ki, pv[:n7a], pi[:n7a],
                         "every station weighted")
cv, ci = plan7a.call_folded_chunked(g7a, 3)
if not (torch.equal(cv, kv) and torch.equal(ci, ki)):
    raise AssertionError("3-chunk call != single call (every station "
                         "weighted)")
print(f"bp kernel vs plain, every station weighted (100k x 64 pairs, "
      f"{plan7a.tables.n_stages} stages over {plan7a.tables.n_tiles} source "
      f"tiles, 2^13 samples): max|diff| {errs_bp[-1]:.3g}, {near7a} samples "
      f"with another source within {ATOL} of the maximum", flush=True)
del g7a, plan7a
# a wide row: one source's moveout on one station-phase tens of thousands
# of samples from its tile's others, so that station-phase is staged as
# two rows of that tile
mv_wide, n7w = mv_bp.copy(), 2**16
src_w = 4321
sta_w = int(np.flatnonzero(w_src_bp[src_w])[0])
mv_wide[src_w, sta_w, 1] += 40_000
plan7w = bp.BeamformPlan(mv_wide, w_ph_bp, w_src_bp, n7w)
tab7w = plan7w.tables
tile_w = src_w // bp.SRC_TILE
rows_w = tab7w.ent_sp[int(tab7w.stage_row[tab7w.tile_stage[tile_w]]):
                      int(tab7w.stage_row[tab7w.tile_stage[tile_w + 1]])]
if (int((rows_w == 2 * sta_w + 1).sum()) != 2
        or int(tab7w.ent_span.max()) >= bp.ROW_CAP):
    raise AssertionError("the wide row was not staged as two rows")
feat7w = brng.uniform(0, 1, size=(N_STA_BP, 3, n7w)).astype(np.float32)
g7w = plan7w.fold_and_pad(feat7w)
kv, ki = plan7w.call_folded(g7w)
pv, pi = bp.beamform_plain(g7w, tab7w)
errs_bp.append(float((kv - pv[:n7w]).abs().max()))
near7w = check_first_max(tab7w, g7w, kv, ki, pv[:n7w], pi[:n7w],
                         "a wide row")
# the full beam of that tile and its neighbours
s_w = slice((tile_w - 1) * bp.SRC_TILE, (tile_w + 2) * bp.SRC_TILE)
none7w = bp.BeamformPlan(mv_wide[s_w], w_ph_bp, w_src_bp[s_w], n7w,
                         reduce="none")
g7wn = none7w.fold_and_pad(feat7w)
kb = none7w.call_folded(g7wn)
pb = bp.beamform_plain(g7wn, none7w.tables, reduce="none")
torch.cuda.synchronize()
if (not torch.allclose(kb, pb, rtol=RTOL, atol=ATOL)
        or float(kb[src_w - s_w.start, :20_000].abs().min()) == 0.0):
    raise AssertionError("bp kernel != plain (a wide row, none)")
print(f"bp kernel vs plain, a wide row (source {src_w}'s S moveout at "
      f"station {sta_w} moved by 40,000 samples: {tab7w.ent_sp.numel()} "
      f"staged rows, spread at most {int(tab7w.ent_span.max())}): max|diff| "
      f"{errs_bp[-1]:.3g}, {near7w} samples with another source within "
      f"{ATOL} of the maximum", flush=True)
del g7w, g7wn, plan7w, none7w, kb, pb
t0p = time.perf_counter()
bp.build_tables(*_flatten_moveouts(mv_bp, w_ph_bp, w_src_bp), N_SAMP, True,
                "cpu")
plan_build_s = time.perf_counter() - t0p
print(f"bp plan tables of the day (100k sources, 2,160,000 samples) built "
      f"on the host in {plan_build_s:.2f} s", flush=True)
bad = mv_bp.copy()
bad[7, 3, 1] = -2
try:
    bp.BeamformPlan(bad, w_ph_bp, w_src_bp, 2**12)
except ValueError:
    pass
else:
    raise AssertionError("negative moveouts reached the plan")
try:
    bp.bp_beam(g7.double(), plan7.tables)
except ValueError:
    pass
else:
    raise AssertionError("a float64 feature array reached the kernel")
print(f"bp kernel vs plain (100k x 32 x 2, closest-10, both policies; max "
      f"on 2^14, none on 2^12): max|diff| {max(errs_bp):.3g} "
      f"(rtol={RTOL}, atol={ATOL}), first-max argmax and ties, 3-chunk "
      f"call bit-identical ({time.perf_counter() - t0:.1f} s) [{CARD}]",
      flush=True)
del g7, g7n, plan7, none7


# 8. the BP main path at full size
stations_bp, travel, net_bp = W7.stations, W7.travel, W7.network
BP_DAYS, make_bp_day, bp_reader = W7.days, W7.make_day, W7.reader
make_bp_data = W7.make_data
cfg_bp = Config(sampling_rate_hz=SR)
zero_counts()
t0 = time.perf_counter()
res_bp = workflow.scan_days(list(DATES), make_bp_data, cfg=cfg_bp,
                            stage="bp", network=net_bp, travel_times=travel)
wall_bp = time.perf_counter() - t0
launches_bp = bp.bp_beam.launches
plain_bp = bp.beamform_plain.calls
if launches_bp < len(DATES) or plain_bp != 0:
    raise AssertionError(f"bp main path: {launches_bp} kernel launches, "
                         f"{plain_bp} plain-version calls")
for day, evs in BP_EVENTS.items():
    for o, src in evs:
        t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
        hits = [e for e in res_bp[day]
                if abs(e.origin_time_epoch - t_exp) <= 2.0 / SR
                and np.all(np.abs(src_km[e.aux_data["source_index"]]
                                  - src_km[src]) <= spacing + 1e-9)]
        if not hits:
            raise AssertionError(
                f"bp event at sample {o} of {day} (source {src}) not found: "
                f"{[(e.origin_time_epoch - t_exp, e.aux_data) for e in res_bp[day]]}")
stage_s = {k: GLOBAL_TIMER.times[k] / len(DATES)
           for k in ("bp_features", "bp_backproject", "bp_detect")}
gpts = GLOBAL_TIMER.meters["beam_points"] / GLOBAL_TIMER.times[
    "bp_backproject"] / 1e9
print(f"scan_days bp: {({d: len(v) for d, v in res_bp.items()})} "
      f"detections, every injected event found; s/day: "
      + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
      + f"; {gpts:.1f} Gpoints/s in bp_backproject; campaign wall "
      f"{wall_bp:.1f} s; kernel launches {launches_bp} [{CARD}]", flush=True)


# 9. the BP kernel's numbers at day shape
bf9 = Beamformer(network=net_bp, phases=["P", "S"], travel_times=travel,
                 cfg=cfg_bp)
bf9.set_weights(weights_phases=w_ph_bp)
bf9.set_weights_sources(method="closest_stations", num_closest_stations=10,
                        normalize=True)
plan9 = bf9._plan(N_SAMP, "max", "strict")
g9 = plan9.fold_and_pad(saturated_envelopes(BP_DAYS["d2"])[0])
bound_bp, bound_by_bp = bp_bound_ms(plan9.tables, g9)
kv9, ki9 = plan9.call_folded(g9)
ms_bp = cuda_ms(lambda: plan9.call_folded(g9), 3)
t0 = time.perf_counter()
pv9, pi9 = bp.beamform_plain(g9, plan9.tables)
torch.cuda.synchronize()
plain_ms_bp = 1e3 * (time.perf_counter() - t0)
pv9, pi9 = pv9[:N_SAMP], pi9[:N_SAMP]
errs_bp.append(float((kv9 - pv9).abs().max()))
near9 = check_first_max(plan9.tables, g9, kv9, ki9, pv9, pi9, "one day")
pts = plan9.n_src * N_SAMP
print(f"bp kernel, one day: {ms_bp:.2f} ms ({pts / ms_bp / 1e6:.0f} "
      f"Gpoints/s, {plan9.tables.n_pairs * N_SAMP / ms_bp / 1e9:.2f} T "
      f"multiply-adds/s) in {plan9.n_t_blocks} tiles x "
      f"{plan9.tables.n_tiles} source tiles ({plan9.tables.n_stages} "
      f"stages, {plan9.tables.fma_per_word:.2f} multiply-adds per word "
      f"loaded from shared memory, {plan9.tables.n_pairs / plan9.tables.n_items:.2f} "
      f"sources per item), bound {bound_bp:.2f} ms ({bound_by_bp}), plain "
      f"{plain_ms_bp:.0f} ms; max|diff| {errs_bp[-1]:.3g}, first-max rule "
      f"held, indices differ at {near9} samples, each a tie within {ATOL} "
      f"[{CARD}]",
      flush=True)
del pv9, pi9, g9

# where a warm BP day's time goes: the stage timers of one more day on the
# warm engine (its plan is cached), then torch.profiler over another
day_bp = make_bp_data("d2")
before = {k: GLOBAL_TIMER.times[k] for k in stage_s}
t0 = time.perf_counter()
workflow.backproject_day(day_bp, net_bp, travel, cfg=cfg_bp, bf=bf9)
torch.cuda.synchronize()
warm_bp_s = time.perf_counter() - t0
warm_stages = {k: GLOBAL_TIMER.times[k] - before[k] for k in stage_s}
with torch.profiler.profile(activities=acts) as prof_bp:
    t0 = time.perf_counter()
    workflow.backproject_day(day_bp, net_bp, travel, cfg=cfg_bp, bf=bf9)
    torch.cuda.synchronize()
    prof_bp_s = time.perf_counter() - t0
busy_bp, top_bp = device_profile(prof_bp, "chip_smoke_bp_profile.txt")
print(f"warm bp day: {warm_bp_s:.3f} s: "
      + ", ".join(f"{k} {v:.3f} s" for k, v in warm_stages.items())
      + f"; profiled day {prof_bp_s:.3f} s, device busy {busy_bp:.1f} ms "
      f"({100 * busy_bp / (1e3 * prof_bp_s):.0f}%): {top_bp} [{CARD}]",
      flush=True)


# 10. the split kernel against its plain version at full bank width
plan10 = mf.MatchedFilterPlan(tpl, mv, wts, n_win, precision="high")
if (plan10.pad_left, plan10.ext) != (plan3.pad_left, plan3.ext):
    raise AssertionError("the two rungs disagree on the padded layout")
got10 = plan10(dp3)
ref10 = plain_of(plan10, dp3)
torch.cuda.synchronize()
err10 = float((got10 - ref10).abs().max())
if not torch.allclose(got10, ref10, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"split kernel != plain version: max|diff| "
                         f"{err10:.3g}")
if float(got10[:, 40050:49400].abs().max()) != 0.0:
    raise AssertionError("split kernel: the zero-filled gap does not give "
                         "CC = 0")
f32_10 = plan3(dp3)
diff_f32 = float((got10 - f32_10).abs().max())
if torch.equal(got10, f32_10) or not bool(
        (mf.split_rows_parts(plan10.filt_rows, L)[1].float() != 0).any()):
    raise AssertionError("the `high` plan gave the f32 kernel's bits: wrong "
                         "kernel, or a zeroed lo part")
lags10 = rng.integers(0, n_win - L, size=64)
lags10[:4] = (0, n_win - L, 39990, 50003)       # the edges, the gap's rim
worst10 = 0.0
for t10 in (0, 1, N_TP // 2, N_TP - 1):
    exact = matched_filter_at(tpl[t10], mv[t10], wts[t10], win, lags10)
    worst10 = max(worst10, float(np.abs(
        exact - got10[t10, lags10].cpu().numpy()).max()))
if worst10 > ATOL_HIGH:
    raise AssertionError(f"split kernel: max|CC - oracle| {worst10:.3g}")
got10s = mf.matched_filter(tpl, mv, wts, win, step=2, precision="high")
if not torch.allclose(got10s, ref10[:, ::2][:, : (n_win - L) // 2 + 1],
                      rtol=RTOL, atol=ATOL):
    raise AssertionError("split kernel: step=2 disagrees with the "
                         "decimated scan")
call10 = dict(n_tp=plan10.n_tp, L=L, n_corr=plan10.n_corr_unit,
              lo_p=plan10.lo_p, hi_p=plan10.hi_p,
              max_delta=plan10.max_delta)
for what, args in (
        ("a float64 day", (dp3.double(), plan10.filt_rows)),
        ("f32 template rows", (dp3, plan10.filt_rows.float()))):
    try:
        mf.mf_cc_split(*args, plan10.mv_table, plan10.tile_lo, **call10)
    except ValueError:
        continue
    raise AssertionError(f"{what} reached the split kernel")
ms10 = cuda_ms(lambda: plan10(dp3), 5)
t0 = time.perf_counter()
plain_of(plan10, dp3)
torch.cuda.synchronize()
plain10 = 1e3 * (time.perf_counter() - t0)
print(f"split kernel vs plain (128 x 30 x L=200, 2^17 samples): max|diff| "
      f"{err10:.3g} (rtol={RTOL}, atol={ATOL}), max|CC - oracle| "
      f"{worst10:.3g} at {4 * len(lags10)} lags (atol={ATOL_HIGH}), "
      f"max|diff| from the f32 kernel {diff_f32:.3g}; kernel {ms10:.3f} ms "
      f"(f32 kernel {ms3:.3f} ms), plain {plain10:.1f} ms [{CARD}]",
      flush=True)
del got10, ref10, f32_10, got10s


# 11. the `high` rung's main path at full size
zero_counts()
kw_high = dict(kw, rng=np.random.default_rng(SEED + 4))
before11 = GLOBAL_TIMER.times["mf_scan"]
t0 = time.perf_counter()
res11 = workflow.scan_days(list(DATES), make_data, tg, cfg=cfg,
                           precision="high", **kw_high)
wall11 = time.perf_counter() - t0
launches11 = mf.mf_cc_split.launches
others11 = (mf.mf_cc.launches + mf.mf_cc_highest.launches,
            mf.matched_filter_plain.calls,
            mf.matched_filter_split_plain.calls)
if launches11 < len(DATES) or others11 != (0, 0, 0):
    raise AssertionError(f"high main path: {launches11} split-kernel "
                         f"launches; f32 kernel, plain, split plain: "
                         f"{others11}")
if mf.split_day.launches != launches11:
    raise AssertionError(f"high main path: {mf.split_day.launches} pre-pass "
                         f"launches for {launches11} of the split kernel")
for day, tid, o in REPEATS:
    t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
    hits = [e for e in res11[day][str(tid)]
            if abs(e.origin_time_epoch - t_exp) < 0.5 / SR]
    if not hits or hits[0].aux_data["cc"] < 0.99:
        raise AssertionError(f"high: repeat of template {tid} at sample {o} "
                             f"of {day} not detected with CC >= 0.99: {hits}")
scan11_s = (GLOBAL_TIMER.times["mf_scan"] - before11) / len(DATES)
engine11 = MatchedFilter(tg, cfg=cfg, precision="high",
                         **{k: v for k, v in kw_high.items()
                            if k != "minimum_interevent_time"})
worst11, n11 = 0.0, 0
for day in DATES:
    data11 = make_data(day)
    engine11.set_data(data11)
    engine11.set_weights_channels(method="simple", normalize=True)
    for tid, evs in res11[day].items():
        tt = int(tg.tindexes[tid])
        idx = np.array([int(round((e.origin_time_epoch - data11.date_epoch)
                                  * SR)) for e in evs], np.int64)
        if not len(idx):
            continue
        exact = matched_filter_at(tg.waveforms_arr[tt], tg.moveouts_arr[tt],
                                  engine11.weights_channels[tt],
                                  engine11.data_arr, idx)
        worst11 = max(worst11, float(np.abs(
            exact - np.array([e.aux_data["cc"] for e in evs])).max()))
        n11 += len(idx)
if n11 < N_TP + len(REPEATS) or worst11 > ATOL_HIGH:
    raise AssertionError(f"high: {n11} detections, max|CC - oracle| "
                         f"{worst11:.3g}")
if not worst < worst11:
    raise AssertionError(f"highest (phase 5, max|CC - oracle| {worst:.3g}) "
                         f"is not tighter than high ({worst11:.3g})")
t0 = time.perf_counter()
cat11 = workflow.assemble_catalog(
    {tid: [e for day in DATES for e in res11[day][tid]]
     for tid in res11["d1"]}, tg)
torch.cuda.synchronize()
cat11_s = time.perf_counter() - t0
if cat11.n_events != n11:
    raise AssertionError(f"catalog of {cat11.n_events} events from {n11} "
                         f"detections")
for day, tid, o in REPEATS:
    t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
    rows = np.flatnonzero(
        (np.abs(cat11.origin_times_epoch - t_exp) < 0.5 / SR)
        & (cat11["tid"].astype(str) == str(tid)))
    if len(rows) != 1 or not cat11["unique_event"][rows[0]]:
        raise AssertionError(f"repeat of template {tid} at sample {o} of "
                             f"{day} is not one unique event of the catalog")
print(f"scan_days high: {({d: sum(len(v) for v in r.values()) for d, r in res11.items()})} "
      f"detections, every repeat found, max|CC - oracle| {worst11:.3g} over "
      f"{n11} detections; {scan11_s:.3f} s/day matched_filter_day, "
      f"{macs_day / scan11_s / 1e9:.0f} GMAC/s end to end, campaign wall "
      f"{wall11:.1f} s; split-kernel launches {launches11}; catalog of "
      f"{cat11.n_events} events, {int(cat11['unique_event'].sum())} unique, "
      f"assemble_catalog {cat11_s:.2f} s (inter-template CC of {N_TP} "
      f"templates on the card) [{CARD}]", flush=True)


# 12. the campaign end to end on the BP world, at `high`
def bp_window_reader(where, stations=None, channels=None, starttime=None,
                     endtime=None, **kwargs):
    """In-memory reader of windows of the BP days: honours the station
    list, the channel pattern ('*Z') and the time window."""
    key = where.split("/")[-1]
    t0 = T0_EPOCH + DAY_SEC * (int(key[1:]) - 1)
    out = Stream()
    for s, name in enumerate(stations_bp):
        if stations is not None and name not in stations:
            continue
        for c, comp in enumerate("NEZ"):
            if channels is None or channels.endswith(comp):
                out += Trace(BP_DAYS[key][s, c], station=name, network="XX",
                             channel=f"HH{comp}", sampling_rate=SR,
                             starttime=t0)
    return out.slice(starttime, endtime)


cfg12 = Config(sampling_rate_hz=SR, template_len_sec=L / SR)
zero_counts()
steps12 = {}
t0 = time.perf_counter()
day12 = make_bp_data("d1")
_, dets12 = workflow.backproject_day(day12, net_bp, travel, cfg=cfg12, bf=bf9)
steps12["backproject_day"] = time.perf_counter() - t0
t0 = time.perf_counter()
tg12 = workflow.build_templates(dets12, net_bp, cfg=cfg12,
                                data_reader=bp_window_reader)
steps12["build_templates"] = time.perf_counter() - t0
t0 = time.perf_counter()
engine12 = MatchedFilter(tg12, cfg=cfg12, precision="high", min_channels=6,
                         min_stations=3, max_kurto=1e6,
                         rng=np.random.default_rng(SEED + 5))
mf12 = workflow.matched_filter_day(tg12, day12, cfg=cfg12, mf=engine12)
torch.cuda.synchronize()
steps12["matched_filter_day"] = time.perf_counter() - t0
t0 = time.perf_counter()
cat12 = workflow.assemble_catalog(mf12, tg12)
steps12["assemble_catalog"] = time.perf_counter() - t0
counts12 = (bp.bp_beam.launches, mf.mf_cc_split.launches)
others12 = (bp.beamform_plain.calls,
            mf.mf_cc.launches + mf.mf_cc_highest.launches,
            mf.matched_filter_plain.calls,
            mf.matched_filter_split_plain.calls)
if min(counts12) < 1 or others12 != (0, 0, 0, 0):
    raise AssertionError(f"end to end: bp and split-kernel launches "
                         f"{counts12}; plain bp, f32 kernel, plain, split "
                         f"plain: {others12}")
if tg12.n_templates < len(BP_EVENTS["d1"]):
    raise AssertionError(f"{tg12.n_templates} templates from "
                         f"{len(dets12)} detections")
for o, src in BP_EVENTS["d1"]:
    dt12 = np.abs(cat12.origin_times_epoch - (T0_EPOCH + o / SR))
    near = dt12 <= 2.5 / SR
    group = dt12 <= 3.0              # assemble_catalog's dt_criterion
    if (int(near.sum()) != 1 or cat12["cc"][near][0] < 0.99
            or not bool(cat12["unique_event"][near][0])):
        raise AssertionError(
            f"event at sample {o} (source {src}): {int(near.sum())} catalog "
            f"rows at its time, {int(group.sum())} within 3 s: "
            f"{list(zip(cat12['origin_time'][group], cat12['tid'][group], cat12['cc'][group], cat12['unique_event'][group]))}")
# this path's plan is another shape than phases 10, 11 and 13 hold to the
# plain version (one ragged template tile, 96 channels, the bank's moveouts
# spread wide inside the tile): the whole day's CC against the plain
# version, and every detection's CC against the float64 oracle
plans12 = [p for ps in engine12._plans.values() for p in ps]
if sum(p.n_tp for p in plans12) != tg12.n_templates:
    raise AssertionError(f"end to end: plans of {[p.n_tp for p in plans12]} "
                         f"templates for a bank of {tg12.n_templates}")
dp12 = engine12._data_pad
got12 = torch.cat([p(dp12) for p in plans12])
ref12 = torch.cat([plain_of(p, dp12) for p in plans12])
torch.cuda.synchronize()
err12 = float((got12 - ref12).abs().max())
if not torch.allclose(got12, ref12, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"end to end: split kernel != plain version at "
                         f"{tg12.n_templates} x {plans12[0].n_ch}: max|diff| "
                         f"{err12:.3g}")
del got12, ref12
worst12, n12 = 0.0, 0
for tid, evs in mf12.items():
    if not evs:
        continue
    tt = int(tg12.tindexes[tid])
    idx = np.array([int(round((e.origin_time_epoch - day12.date_epoch) * SR))
                    for e in evs], np.int64)
    exact = matched_filter_at(tg12.waveforms_arr[tt], tg12.moveouts_arr[tt],
                              engine12.weights_channels[tt],
                              engine12.data_arr, idx)
    worst12 = max(worst12, float(np.abs(
        exact - np.array([e.aux_data["cc"] for e in evs])).max()))
    n12 += len(idx)
if n12 != cat12.n_events or worst12 > ATOL_HIGH:
    raise AssertionError(f"end to end: {n12} detections, catalog of "
                         f"{cat12.n_events}, max|CC - oracle| {worst12:.3g}")
print(f"end to end at high: {len(dets12)} bp detections -> "
      f"{tg12.n_templates} templates ({len(tg12.stations)} stations x 3) -> "
      f"{sum(len(v) for v in mf12.values())} mf detections -> catalog of "
      f"{cat12.n_events}, {int(cat12['unique_event'].sum())} unique; the 3 "
      f"injected events each once in it and the kept row of their group of "
      f"multiples; split kernel vs plain on this plan "
      f"({tg12.n_templates} x {plans12[0].n_ch}, max_delta "
      f"{max(p.max_delta for p in plans12)}): max|diff| {err12:.3g} "
      f"(rtol={RTOL}, atol={ATOL}), max|CC - oracle| {worst12:.3g} over "
      f"{n12} detections (atol={ATOL_HIGH}); "
      + ", ".join(f"{k} {v:.2f} s" for k, v in steps12.items())
      + f"; bp launches {counts12[0]}, split-kernel launches {counts12[1]} "
      f"[{CARD}]", flush=True)
del day12, mf12, dp12


# 13. the split kernel's numbers at day shape, beside the f32 kernel's
workflow.matched_filter_day(tg, day1, cfg=cfg, mf=engine11,
                            minimum_interevent_time=5.0)
plan13 = next(iter(engine11._plans.values()))[0]
dp13 = engine11._data_pad
bound13, bound_by13, _, _ = mf_bound_ms(plan13, dp13)
got13 = plan13(dp13)
t0 = time.perf_counter()
ref13 = plain_of(plan13, dp13)
torch.cuda.synchronize()
plain13 = 1e3 * (time.perf_counter() - t0)
err13 = float((got13 - ref13).abs().max())
if not torch.allclose(got13, ref13, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"day-size split kernel != plain: max|diff| "
                         f"{err13:.3g}")
del ref13
f32_13 = plan(dp)
diff13 = float((got13 - f32_13).abs().max())
err13_f32 = float((f32_13 - ref5).abs().max())
if not torch.allclose(f32_13, ref5, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"day-size f32-class kernel != plain: max|diff| "
                         f"{err13_f32:.3g}")
del got13, f32_13, ref5
ms13 = cuda_ms(lambda: plan13(dp13), 5)
ms13_pre = cuda_ms(lambda: mf.split_day(dp13, L), 5)
ms13_f32 = cuda_ms(lambda: plan(dp), 5)
print(f"mf split kernel, one day: {ms13:.2f} ms ({macs / ms13 / 1e6:.0f} "
      f"GMAC/s; of it the pre-pass (bf16 parts and y of the day) "
      f"{ms13_pre:.3f} ms, {mf.split_stages(L, plan13.max_delta)} ring "
      f"stages; the f32-class kernel on the same bank and day "
      f"{ms13_f32:.2f} ms), "
      f"bound {bound13:.2f} ms ({bound_by13}: 3 bf16 products at "
      f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s), plain {plain13:.0f} ms; "
      f"max|diff| from plain {err13:.3g}, from the f32 kernel {diff13:.3g} "
      f"[{CARD}]", flush=True)

# 14. PhaseNet on the card (f32) against float64 on the CPU
pn_model = init_phasenet(torch.Generator().manual_seed(SEED + 7))
pn_model64 = copy.deepcopy(pn_model).cpu().double()
raw14 = BP_DAYS["d1"][:4, :, 500_000:560_000]
fband = (cfg_bp.min_freq_hz, cfg_bp.max_freq_hz)
t0 = time.perf_counter()
pre14 = preprocess_batch(raw14, SR, *fband)
pre14_64 = preprocess_batch(torch.from_numpy(raw14.astype(np.float64)), SR,
                            *fband)
nb14 = normalize_batch(pre14_64.float().cuda())
nb14_64 = normalize_batch(pre14_64)
torch.backends.cudnn.allow_tf32 = True   # the forward must not take it
pr14 = phasenet_probas_device(pn_model, pre14_64.float())
if not torch.backends.cudnn.allow_tf32:
    raise AssertionError("the PhaseNet forward left the TF32 flag changed")
torch.backends.cudnn.allow_tf32 = False
pr14_64 = phasenet_probas_device(pn_model64, pre14_64)
if not (pre14.is_cuda and nb14.is_cuda and pr14.is_cuda
        and pr14.dtype == torch.float32):
    raise AssertionError("phase 14: the card results are not f32 on the card")
err_pre14 = float((pre14.cpu().double() - pre14_64).abs().max()
                  / pre14_64.abs().max())
err_nb14 = float((nb14.cpu().double() - nb14_64).abs().max()
                 / nb14_64.abs().max())
err_pr14 = float((pr14.cpu().double() - pr14_64).abs().max())
sum_err14 = float((pr14.sum(dim=1) - 1.0).abs().max())
if (err_pre14 > 1e-4 or err_nb14 > 1e-4 or err_pr14 > 1e-5
        or sum_err14 > 1e-5 or not bool(torch.isfinite(pr14).all())):
    raise AssertionError(
        f"PhaseNet on the card vs float64: preprocess {err_pre14:.3g}, "
        f"normalize {err_nb14:.3g} (relative, gate 1e-4), probabilities "
        f"{err_pr14:.3g}, sums {sum_err14:.3g} (gate 1e-5)")
print(f"phasenet on the card (f32, TF32 off) vs float64 on the CPU, 4 "
      f"stations x 60,000 samples: preprocess_batch {err_pre14:.3g}, "
      f"normalize_batch {err_nb14:.3g} (of the traces' max, gate 1e-4), "
      f"probabilities {err_pr14:.3g} (gate 1e-5), |sum - 1| {sum_err14:.3g} "
      f"({time.perf_counter() - t0:.1f} s) [{CARD}]", flush=True)
del pn_model64, pre14, pre14_64, nb14, nb14_64, pr14, pr14_64


# 15. the PhaseNet BP day at full width, through kernel #3
pn_fn = workflow.phasenet_feature_fn(pn_model)
pn_kept = {}


def pn_feature_fn(arr):
    """Preprocessing on the card, then PhaseNet's P/S probabilities."""
    with GLOBAL_TIMER.stage("pn_preprocess"):
        x = preprocess_batch(arr, SR, *fband)
        torch.cuda.synchronize()
    pn_kept["f"] = pn_fn(x)
    return pn_kept["f"]


# random weights put no physics into the probabilities, so the beam of the
# injected events stands lower above its median than the envelopes' does: a
# threshold of 4 deviations (15 for the envelopes) gives the picks events
cfg_pn = Config(sampling_rate_hz=SR, n_dev_bp_threshold=4.0)
bf15 = Beamformer(network=net_bp, phases=["P", "S"], travel_times=travel,
                  cfg=cfg_pn)
PN_STAGES = ("bp_features", "pn_preprocess", "pn_normalize", "pn_forward",
             "bp_backproject", "bp_detect")


def pn_day(data):
    """One PhaseNet BP day on bf15 (the first builds its plan): (detections,
    launches, plain calls, wall s, stage s)."""
    zero_counts()
    before = {k: GLOBAL_TIMER.times[k] for k in PN_STAGES}
    t0 = time.perf_counter()
    _, dets = workflow.backproject_day(data, net_bp, travel, cfg=cfg_pn,
                                       bf=bf15, feature_fn=pn_feature_fn)
    torch.cuda.synchronize()
    return (dets, bp.bp_beam.launches, bp.beamform_plain.calls,
            time.perf_counter() - t0,
            {k: GLOBAL_TIMER.times[k] - before[k] for k in PN_STAGES})


t15 = time.perf_counter()
day15 = make_bp_data("d1")
runs15 = [pn_day(day15)]
torch.cuda.reset_peak_memory_stats()
runs15.append(pn_day(day15))
peak15 = torch.cuda.max_memory_allocated() / 2**30
feat15 = pn_kept["f"]
if not (feat15.is_cuda and tuple(feat15.shape) == (N_STA_BP, 2, N_SAMP)):
    raise AssertionError(f"PhaseNet features {tuple(feat15.shape)} on "
                         f"{feat15.device}")
for dets, n_launch, n_plain, _, _ in runs15:
    if n_launch != 11 or n_plain != 0:
        raise AssertionError(f"PhaseNet bp day: {n_launch} kernel launches, "
                             f"{n_plain} plain-version calls")
dets15 = runs15[1][0]
keys15 = [[(int(round((e.origin_time_epoch - day15.date_epoch) * SR)),
            e.aux_data["source_index"]) for e in r[0]] for r in runs15]
if keys15[0] != keys15[1] or not dets15:
    raise AssertionError(f"PhaseNet bp day: the two runs disagree or found "
                         f"nothing: {len(keys15[0])} / {len(keys15[1])}")
launches_pn = runs15[1][1]
with torch.profiler.profile(activities=acts) as prof_pn:
    t0 = time.perf_counter()
    workflow.backproject_day(day15, net_bp, travel, cfg=cfg_pn, bf=bf15,
                             feature_fn=pn_feature_fn)
    torch.cuda.synchronize()
    prof_pn_s = time.perf_counter() - t0
busy_pn, top_pn = device_profile(prof_pn, "chip_smoke_pn_profile.txt")
# the beam of a cut of the day's features against the plain version
n15 = 100_000
a15 = min(max(keys15[1][0][0] - n15 // 2, 0), N_SAMP - n15)
plan15c = bp.BeamformPlan(bf15.moveouts, bf15.weights_phases,
                          bf15.weights_sources, n15)
g15c = plan15c.fold_and_pad(feat15[..., a15: a15 + n15])
kv15, ki15 = plan15c.call_folded(g15c)
pv15, pi15 = bp.beamform_plain(g15c, plan15c.tables)
err15 = float((kv15 - pv15[:n15]).abs().max())
near15 = check_first_max(plan15c.tables, g15c, kv15, ki15, pv15[:n15],
                         pi15[:n15], "PhaseNet features")
errs_bp.append(err15)
del g15c, kv15, ki15, pv15, pi15, plan15c
# kernel #3 on the day's PhaseNet features
plan15 = bf15._plan(N_SAMP, "max", "strict")
g15 = plan15.fold_and_pad(feat15)
bound15, bound_by15 = bp_bound_ms(plan15.tables, g15)
ms15 = cuda_ms(lambda: plan15.call_folded(g15), 2)
del g15
wall15, st15 = runs15[1][3], runs15[1][4]
print(f"phasenet bp day (32 x 2 x 2,160,000 features on the card, 100k "
      f"sources): {len(dets15)} detections, the same (sample, source) in "
      f"both runs; kernel launches {launches_pn} a run, plain calls 0; "
      f"warm day {wall15:.3f} s: "
      + ", ".join(f"{k} {v:.3f} s" for k, v in st15.items())
      + f"; profiled day {prof_pn_s:.3f} s, device busy {busy_pn:.1f} ms "
      f"({100 * busy_pn / (1e3 * prof_pn_s):.0f}%): {top_pn}; the beam of "
      f"samples {a15}-{a15 + n15} vs plain: max|diff| {err15:.3g} "
      f"(rtol={RTOL}, atol={ATOL}), first-max rule held, {near15} samples "
      f"with another source within {ATOL} of the maximum; kernel "
      f"{ms15:.2f} ms a day, bound {bound15:.2f} ms ({bound_by15}); peak "
      f"device memory of the warm day {peak15:.2f} GiB [{CARD}]", flush=True)
del plan15


# 16. P/S picks on the PhaseNet day's detections
probas16 = feat15.cpu().numpy()
wt16 = WaveformTransform(probas16, stations_bp, ["P", "S"], day15.date, SR)
thr16 = {f"threshold_{ph}": float(np.median(probas16[:, p, ::101]))
         for p, ph in enumerate("PS")}
DUR16, OFF16 = 90.0, 20.0
evs16 = dets15[:20]
t0 = time.perf_counter()
tables16 = [ev.pick_PS_phases(DUR16, offset_ot=OFF16, waveform_transform=wt16,
                              **thr16) for ev in evs16]
ms16 = 1e3 * (time.perf_counter() - t0) / len(evs16)
n_picks16 = 0
for ev, table in zip(evs16, tables16):
    sub = wt16.slice(utc_from_epoch(ev.origin_time_epoch - OFF16),
                     duration=DUR16, stations=list(ev.stations),
                     components=["P", "S"]).transform_arr
    rows = {}
    for s, sta in enumerate(ev.stations):
        rows[sta] = {}
        for p, ph in enumerate("PS"):
            v, m, sd = find_picks(sub[s, p], thr16[f"threshold_{ph}"])
            rows[sta].update({f"{ph}_probas": v,
                              f"{ph}_picks": m / SR * ev.sr,
                              f"{ph}_unc": sd / SR * ev.sr})
    want = get_picks(candidates(rows), buffer_length=0)
    for c in want.columns:
        if not np.array_equal(table[c], want[c], equal_nan=True):
            raise AssertionError(f"event {ev.id}: pick_PS_phases {c} != "
                                 f"find_picks + get_picks")
    n_picks16 += int(np.isfinite(table["P_picks"]).sum()
                     + np.isfinite(table["S_picks"]).sum())
if n_picks16 == 0:
    raise AssertionError("no picks on the PhaseNet day's detections")
picker16 = make_picker(pn_model)
cols16 = [f"{ph}_{c}" for ph in "PS" for c in ("picks", "probas", "unc")]
t0 = time.perf_counter()
for ev in dets15[:3]:
    table = ev.pick_PS_phases(DUR16, offset_ot=OFF16, picker=picker16,
                              data_reader=bp_window_reader, **thr16)
    if (list(table.columns) != cols16 + ["P_abs_picks", "S_abs_picks"]
            or len(table) != len(ev.stations)
            or any(table[c].dtype != np.float32 for c in cols16)
            or any(table[c].dtype != np.dtype("datetime64[ns]")
                   for c in ("P_abs_picks", "S_abs_picks"))):
        raise AssertionError(
            f"picker route: columns {list(table.columns)}, dtypes "
            f"{[table[c].dtype for c in table.columns]}")
ms16p = 1e3 * (time.perf_counter() - t0) / 3
print(f"picks: pick_PS_phases over the day's WaveformTransform on "
      f"{len(evs16)} detections ({n_picks16} P/S picks at median "
      f"thresholds) equal to find_picks + get_picks on the same slices, "
      f"{ms16:.1f} ms per event; the picker route (make_picker, PhaseNet at "
      f"100 Hz on the card) on 3 detections, columns and dtypes as "
      f"specified, {ms16p:.1f} ms per event [{CARD}]", flush=True)
del feat15, probas16, wt16
t16 = time.perf_counter()


# 17. kernel #3 against its plain version on the dense-array plan
del bf9, bf15, engine, engine11, screen, plan13, dp13
torch.cuda.empty_cache()
t17 = time.perf_counter()
dense = build_dense_world()                 # scripts/dense_array.py's world
N_SRC_D, N_STA_D = dense.travel_times.n_sources, dense.network.n_stations
SR_D = dense.data.sr
n_scan = int(round(dense.data.duration * SR_D))
world_s = time.perf_counter() - t17
bf_d = Beamformer(data=dense.data, network=dense.network, phases=["P", "S"],
                  travel_times=dense.travel_times, cfg=dense.cfg)
bf_d.set_weights(weights_phases=workflow.default_weights_phases(N_STA_D))
bf_d.set_weights_sources(method="closest_stations",
                         num_closest_stations=DENSE_CLOSEST, normalize=True)
t0 = time.perf_counter()
plan17 = bf_d._plan(2**12, "max", "strict")     # the tables, built here
tables_d_s = time.perf_counter() - t0
tab_d = plan17.tables
env_d = saturated_envelopes(dense.day)[0]        # (128, 3, n_scan) on card
a17 = int(dense.event_times[0] * SR_D) - 1000  # a cut around the 1st event
errs17, near17 = [], 0
t0 = time.perf_counter()
for oob in ("strict", "flexible"):
    p17 = bf_d._plan(2**12, "max", oob)
    if p17.tables.prog is not tab_d.prog:
        raise AssertionError("a dense plan of another policy rebuilt its "
                             "tables")
    g17 = p17.fold_and_pad(env_d[..., a17: a17 + 2**12])
    kv, ki = p17.call_folded(g17)
    pv, pi = bp.beamform_plain(g17, p17.tables)
    errs17.append(float((kv - pv[: 2**12]).abs().max()))
    near17 += check_first_max(p17.tables, g17, kv, ki, pv[: 2**12],
                              pi[: 2**12], f"dense plan, {oob}")
ms17 = cuda_ms(lambda: p17.call_folded(g17), 3)
bound17, bound_by17 = bp_bound_ms(p17.tables, g17)
t1 = time.perf_counter()
bp.beamform_plain(g17, p17.tables)
torch.cuda.synchronize()
plain17 = 1e3 * (time.perf_counter() - t1)
del g17, kv, ki, pv, pi
p17n = bf_d._plan(2**10, "none", "flexible")
g17n = p17n.fold_and_pad(env_d[..., a17: a17 + 2**10])
kb = p17n.call_folded(g17n)
pb = bp.beamform_plain(g17n, p17n.tables, reduce="none")
torch.cuda.synchronize()
errs17.append(float((kb - pb).abs().max()))
if not torch.allclose(kb, pb, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"bp kernel != plain (dense plan, none): max|diff| "
                         f"{errs17[-1]:.3g}")
del kb, pb, g17n, p17n
errs_bp += errs17
rows17 = np.diff(tab_d.stage_row.cpu().numpy())
print(f"bp kernel vs plain on the dense plan ({N_SRC_D} sources x "
      f"{tab_d.n_sp} station-phases, closest-{DENSE_CLOSEST}: "
      f"{tab_d.n_pairs / N_SRC_D:.1f} used pairs a source, "
      f"{tab_d.n_stages} stages over {tab_d.n_tiles} source tiles, up to "
      f"{rows17.max()} rows a stage, {tab_d.fma_per_word:.2f} multiply-adds "
      f"per word loaded from shared memory): max on 2^12 (strict, flexible) "
      f"and none on 2^10 (flexible), max|diff| {max(errs17):.3g} "
      f"(rtol={RTOL}, atol={ATOL}), first-max rule held, {near17} samples "
      f"with another source within {ATOL} of the maximum; kernel "
      f"{ms17:.3f} ms on 2^12 samples, bound {bound17:.3f} ms "
      f"({bound_by17}), plain {plain17:.0f} ms; world built in "
      f"{world_s:.1f} s, plan tables on the host {tables_d_s:.1f} s "
      f"({time.perf_counter() - t0:.1f} s of checks) [{CARD}]", flush=True)


# 18. the dense scan: `backproject_day` over the dense world on the card
def dense_hits(dets, what):
    """Each injected event's detection: within 2 samples of its origin
    plus the wavelet's envelope peak (its centre) and one lattice spacing
    of its node."""
    lag = (int(1.5 * SR_D) - 1) / 2 / SR_D
    for ev_t in dense.event_times:
        t_exp = dense.data.date_epoch + ev_t + lag
        hits = [e for e in dets
                if abs(e.origin_time_epoch - t_exp) <= 2.0 / SR_D
                and np.all(np.abs(dense.src_km[e.aux_data["source_index"]]
                                  - dense.src_km[dense.event_src])
                           <= dense.spacing_km + 1e-9)]
        if not hits:
            raise AssertionError(
                f"{what}: the event at {ev_t} s (node {dense.event_src}) not "
                f"found: {[(e.origin_time_epoch - t_exp, e.aux_data) for e in dets]}")


kw18 = dict(num_closest_stations=DENSE_CLOSEST, minimum_interevent_time=20.0,
            threshold_window_sec=min(3600.0, dense.data.duration))
stages18 = ("bp_features", "bp_backproject", "bp_detect")
zero_counts()
before = {k: GLOBAL_TIMER.times[k] for k in stages18}
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
_, dets18 = workflow.backproject_day(dense.data, dense.network,
                                     dense.travel_times, cfg=dense.cfg,
                                     bf=bf_d, **kw18)
torch.cuda.synchronize()
wall18 = time.perf_counter() - t0
peak18 = torch.cuda.max_memory_allocated() / 2**30
launches18, plain18 = bp.bp_beam.launches, bp.beamform_plain.calls
st18 = {k: GLOBAL_TIMER.times[k] - before[k] for k in stages18}
if launches18 < 1 or plain18 != 0:
    raise AssertionError(f"dense scan: {launches18} kernel launches, "
                         f"{plain18} plain-version calls")
dense_hits(dets18, "dense scan")
gpts18 = N_SRC_D * n_scan / st18["bp_backproject"] / 1e9
with torch.profiler.profile(activities=acts) as prof18:
    t0 = time.perf_counter()
    _, dets18b = workflow.backproject_day(dense.data, dense.network,
                                          dense.travel_times, cfg=dense.cfg,
                                          bf=bf_d, **kw18)
    torch.cuda.synchronize()
    prof18_s = time.perf_counter() - t0
busy18, top18 = device_profile(prof18, "chip_smoke_dense_profile.txt")
if [e.origin_time_epoch for e in dets18b] != [e.origin_time_epoch
                                              for e in dets18]:
    raise AssertionError("dense scan: a second run found other detections")
plan18 = bf_d._plan(n_scan, "max", "strict")
g18 = plan18.fold_and_pad(env_d)
ms18 = cuda_ms(lambda: plan18.call_folded(g18), 1)
bound18, bound_by18 = bp_bound_ms(plan18.tables, g18)
del g18
print(f"dense scan (backproject_day, {N_STA_D} stations x 3 x {n_scan} "
      f"samples, {N_SRC_D} sources, closest-{DENSE_CLOSEST}): "
      f"{len(dets18)} detections, both injected events found; kernel "
      f"launches {launches18}, plain calls 0; {wall18:.2f} s: "
      + ", ".join(f"{k} {v:.3f} s" for k, v in st18.items())
      + f"; {gpts18:.1f} Gpoints/s in bp_backproject; profiled run "
      f"{prof18_s:.3f} s, device busy {busy18:.1f} ms "
      f"({100 * busy18 / (1e3 * prof18_s):.0f}%): {top18}; kernel "
      f"{ms18:.1f} ms for the scan ({plan18.n_t_blocks} time tiles, "
      f"{ms18 / 1e3 * 86400 / dense.data.duration:.2f} s a day at this rate), "
      f"bound {bound18:.1f} ms ({bound_by18}); peak device memory "
      f"{peak18:.2f} GiB [{CARD}]", flush=True)


# 19. relocation of the best detection on the same 1M-node grid
best = max(dets18, key=lambda d: d.aux_data["maxbeam"])
t_data = dense.data.date_epoch
k19 = max(0, int((best.origin_time_epoch - t_data - 10.0) * SR_D))
reloc = {}
zero_counts()
t19 = time.perf_counter()
for method, sec in (("temporal", 80.0), ("spatial", 60.0)):
    ev = copy.deepcopy(best)
    t0 = time.perf_counter()
    ev.relocate(bf_d, env_d[..., k19: min(n_scan, k19 + int(sec * SR_D))],
                routine="beam", uncertainty_method=method,
                features_starttime=t_data + k19 / SR_D)
    torch.cuda.synchronize()
    reloc[method] = (ev, time.perf_counter() - t0)
    if method == "spatial" and (hasattr(bf_d, "beam")
                                or bf_d.likelihood.shape != (N_SRC_D,)):
        raise AssertionError("spatial relocation: the beam reached the host "
                             "beyond its column at the argmax time")
launches19, plain19 = bp.bp_beam.launches, bp.beamform_plain.calls
if launches19 != 2 or plain19 != 0:
    raise AssertionError(f"relocation: {launches19} kernel launches, "
                         f"{plain19} plain-version calls")
ev_t, ev_s = reloc["temporal"][0], reloc["spatial"][0]
node = dense.src_km[dense.event_src]
src_d = bf_d.source_coordinates
for method, (ev, _) in reloc.items():
    i = int(np.flatnonzero((src_d["longitude"] == ev.longitude)
                           & (src_d["latitude"] == ev.latitude)
                           & (src_d["depth"] == ev.depth))[0])
    at = ev.arrival_times_table
    if (np.any(np.abs(dense.src_km[i] - node) > dense.spacing_km + 1e-9)
            or abs(ev.origin_time_epoch - best.origin_time_epoch) > 2.0
            or not (np.isfinite(ev.hmax_unc) and np.isfinite(ev.vmax_unc))
            or list(at.stations) != list(dense.network.stations)
            or not bool((at["P_tt_sec"] > 0).all())):
        raise AssertionError(
            f"{method} relocation: node {i} ({dense.src_km[i]} km, injected "
            f"{node}), origin {ev.origin_time} vs the detection's "
            f"{best.origin_time}, uncertainties {ev.hmax_unc}, "
            f"{ev.vmax_unc}, {len(at)} arrival rows")
if (ev_t.longitude, ev_t.latitude, ev_t.depth) != (
        ev_s.longitude, ev_s.latitude, ev_s.depth):
    raise AssertionError(f"temporal {ev_t.location} != spatial "
                         f"{ev_s.location}")
err19 = float(two_point_distance(ev_t.longitude, ev_t.latitude, ev_t.depth,
                                 src_d["longitude"][dense.event_src],
                                 src_d["latitude"][dense.event_src],
                                 src_d["depth"][dense.event_src]))
# NLLoc's files from the relocated source's arrival times, as the script
# writes them, and read back
nll_dir = tempfile.mkdtemp(prefix="nlloc_")
at = ev_t.arrival_times_table
ev_t.picks_table = PickTable(at.stations, {
    f"{p}_abs_picks": at[f"{p}_abs_arrival_times"] for p in "PS"})
write_nlloc_obs(ev_t.origin_time, ev_t.picks_table, list(at.stations),
                "event.obs", path=nll_dir)
write_nlloc_control("event.in", "event", "event.obs", nll_dir, nll_dir,
                    "bpmf")
with open(os.path.join(nll_dir, "event.obs")) as f:
    obs = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
with open(os.path.join(nll_dir, "event.in")) as f:
    ctrl = f.read().splitlines()
p_first = str(at["P_abs_arrival_times"][0].astype("datetime64[us]"))
if (len(obs) != 2 * N_STA_D or obs[0][:5] != ["S000", "?", "?", "?", "P"]
        or obs[0][6:9] != [p_first[0:10].replace("-", ""),
                           p_first[11:16].replace(":", ""), p_first[17:26]]
        or any(ln[-1] != "1" for ln in obs)
        or f"LOCFILES {os.path.join(nll_dir, 'event.obs')} NLLOC_OBS "
           f"{os.path.join(nll_dir, 'bpmf')} "
           f"{os.path.join(nll_dir, 'event')}" not in ctrl):
    raise AssertionError(f"NLLoc files: {obs[:2]}, {ctrl[:4]}")
shutil.rmtree(nll_dir)
if shutil.which("NLLoc"):
    raise AssertionError("an NLLoc binary is on PATH: drive the round trip")
ev_n = copy.deepcopy(ev_t)
relocate_nlloc(ev_n)
if ev_n.aux_data["NLLoc_reloc"] is not False or ev_n.location != ev_t.location:
    raise AssertionError("relocate_nlloc without a binary moved the event")
del env_d
print(f"relocation on the {N_SRC_D}-node grid: temporal (80 s, max) "
      f"{reloc['temporal'][1]:.2f} s, spatial (60 s, none: the {N_SRC_D} x "
      f"{int(60 * SR_D)} beam on the card, its argmax there, one column of "
      f"{N_SRC_D} floats to the host) {reloc['spatial'][1]:.2f} s; the same "
      f"hypocentre ({ev_t.longitude:.4f}, {ev_t.latitude:.4f}, "
      f"{ev_t.depth:.2f} km), {err19:.2f} km from the injected node; "
      f"origin {ev_t.origin_time_epoch - best.origin_time_epoch:+.3f} s from "
      f"the detection's; hunc {ev_t.hmax_unc:.2f} / {ev_s.hmax_unc:.2f} km, "
      f"vunc {ev_t.vmax_unc:.2f} / {ev_s.vmax_unc:.2f} km (temporal / "
      f"spatial); arrival times for {len(at)} stations; NLLoc obs "
      f"({len(obs)} picks) and control files written and read back; no "
      f"NLLoc binary: relocate_nlloc leaves NLLoc_reloc False, the round "
      f"trip waits for a binary in the repository [{CARD}]", flush=True)


# 20. the eikonal solver on the card: the dense world's station tables
t20 = time.perf_counter()
nx20, ny20, nz20 = EIK_SHAPE
lons20 = 30.0 + np.arange(nx20) / KM_PER_DEG_DENSE   # 1 km nodes, the box
lats20 = 40.0 + np.arange(ny20) / KM_PER_DEG_DENSE
deps20 = np.arange(float(nz20))
vp20 = np.array([4.5, 5.8, 6.3, 6.8])
models20 = layered_velocity_grid(np.array([0.0, 5.0, 15.0, 30.0]), vp20,
                                 vp20 / 1.75, deps20, (nx20, ny20))
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
tts20, _ = build_travel_time_tables(dense.network, lons20, lats20, deps20,
                                    models20, spacing_km=1.0, n_iters=300)
eik_s = time.perf_counter() - t0
peak20 = torch.cuda.max_memory_allocated() / 2**30
n_solves = sum(len(v) for v in tts20.values())
# (a) homogeneous medium against straight rays (tests/test_eikonal.py)
c20 = (nx20 // 2, ny20 // 2, nz20 // 2)
t_h = eikonal_grid(np.full(EIK_SHAPE, 6.0, np.float32), c20, 1.0,
                   n_iters=300)
dist20 = np.sqrt(((np.arange(nx20) - c20[0]) ** 2.0)[:, None, None]
                 + ((np.arange(ny20) - c20[1]) ** 2.0)[None, :, None]
                 + ((np.arange(nz20) - c20[2]) ** 2.0)[None, None, :])
far20 = dist20 > 3.0
rel20 = np.abs(t_h[far20] - dist20[far20] / 6.0) / (dist20[far20] / 6.0)
axial20 = float(np.abs(t_h[c20[0], c20[1], c20[2]:]
                       - np.arange(nz20 - c20[2]) / 6.0).max())
if (np.median(rel20) >= 0.01 or rel20.max() >= 0.05 or t_h[c20] != 0.0
        or axial20 > 1e-5):
    raise AssertionError(f"eikonal, homogeneous: median relative error "
                         f"{np.median(rel20):.3g}, max {rel20.max():.3g}, "
                         f"axial {axial20:.3g} s")
# (b) two stations of the layered case against float64 on the card
err20 = 0.0
for s in range(2):
    sta = dense.network.stations[s]
    node = (int(np.argmin(np.abs(lons20 - dense.network.longitude[s]))),
            int(np.argmin(np.abs(lats20 - dense.network.latitude[s]))),
            int(np.argmin(np.abs(deps20 - dense.network.depth[s]))))
    for ph in ("P", "S"):
        t64 = eikonal_grids([models20[ph]], [node], 1.0, n_iters=300,
                            dtype=torch.float64)[0]
        err20 = max(err20, float(np.abs(
            tts20[ph][sta] - t64.cpu().numpy().reshape(-1)).max()))
if not np.isfinite(err20) or err20 > 1e-3:
    raise AssertionError(f"eikonal f32 tables vs float64: {err20:.3g} s")
print(f"eikonal on the card: build_travel_time_tables for {N_STA_D} "
      f"stations x P, S on a {nx20} x {ny20} x {nz20}-node, 1 km grid "
      f"(layered vp {vp20.tolist()}, vs = vp / 1.75), 300 sweeps in f32, "
      f"batches of {eikonal_batch(nx20 * ny20 * nz20)}: {eik_s:.2f} s, "
      f"{n_solves / eik_s:.1f} solves/s, "
      f"peak device memory {peak20:.2f} GiB; homogeneous vs straight rays: "
      f"median relative error {np.median(rel20):.2e}, max "
      f"{rel20.max():.2e} beyond 3 nodes, axial {axial20:.1e} s; two "
      f"stations' f32 tables vs float64 on the card: max {err20:.2e} s "
      f"(gate 1e-3) ({time.perf_counter() - t20:.1f} s) [{CARD}]",
      flush=True)
# --------------------------------------------------------------------------
# 21. the magnitude path on the card: miniSEED days and StationXML ->
#     response removal -> spectra -> Mw and Mw* -> compute_magnitudes
t21 = time.perf_counter()
MAG_KW = dict(duration_sec=4.0, attach_response=True, taper_percentage=0.0,
              pre_filt=(0.2, 0.5, 45.0, 49.0))
mag_root = tempfile.mkdtemp(prefix="magnitude_world_")
t0 = time.perf_counter()
mag = build_magnitude_world(mag_root)
world_s = time.perf_counter() - t0
N_EV = len(mag.events)
# three windowed reads against a whole-file decode followed by `slice`
t0 = time.perf_counter()
for f, e, off in ((0, 0, 0.0), (len(mag.files) // 2, N_EV // 2, 7.25),
                  (len(mag.files) - 1, N_EV - 1, 19.99)):
    a21 = mag.events[e].origin_time_epoch + off
    win21 = read_mseed(mag.files[f], a21, a21 + 4.0)
    whole21 = read_mseed(mag.files[f]).slice(a21, a21 + 4.0)
    if not (len(win21) == len(whole21) == 1
            and win21[0].stats.starttime == whole21[0].stats.starttime
            and np.array_equal(win21[0].data, whole21[0].data)
            and len(win21[0].data) == 401):
        raise AssertionError(f"windowed read of {mag.files[f]} at {a21} "
                             "differs from the whole decode")
check21_s = time.perf_counter() - t0
# the card run: each event's stage seconds from wrappers around the reader,
# the response removal and the fit
sec21 = {"read": 0.0, "response": 0.0, "fit": 0.0}
reader21 = timed(data_reader_mseed, sec21, "read")
remove_plain = response.remove_response_arr
response.remove_response_arr = timed(remove_plain, sec21, "response")
fit_plain = Spectrum.fit_average_spectrum
Spectrum.fit_average_spectrum = timed(fit_plain, sec21, "fit")
rows21, kept21 = [], {}
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
held21 = torch.cuda.memory_allocated()   # still held from earlier phases
zero_counts()
t0 = time.perf_counter()
for e, (ev, mw_inj) in enumerate(zip(mag.events, mag.mw)):
    before = dict(sec21)
    t_ev = time.perf_counter()
    win = extract_windows(ev, data_reader=reader21, **MAG_KW)
    t_sp = time.perf_counter()
    spec = compute_moment_magnitude(ev, mag.network, windows=win, Q0=1e9)
    t_star = time.perf_counter()
    star = approximate_moment_magnitude(ev, mag.network, windows=win,
                                        Q0=1e9)
    t_end = time.perf_counter()
    if not spec.fit_success or abs(spec.Mw - mw_inj) >= 0.25:
        raise AssertionError(f"event {e}: Mw {getattr(spec, 'Mw', None)} "
                             f"vs injected {mw_inj:.3f} (gate 0.25)")
    if star is None or abs(star - mw_inj) >= 0.3:
        raise AssertionError(f"event {e}: Mw* {star} vs injected "
                             f"{mw_inj:.3f} (gate 0.3)")
    d = {k: sec21[k] - before[k] for k in sec21}
    rows21.append((mw_inj, spec.Mw, star, d["read"], d["response"],
                   t_sp - t_ev - d["read"] - d["response"],
                   t_star - t_sp - d["fit"], d["fit"], t_end - t_star))
    if e < 2:
        kept21[e] = (win, spec.Mw, star)
run21_s = time.perf_counter() - t0
launches21 = response.apply_spectral_filter.launches
peak21 = (torch.cuda.max_memory_allocated() - held21) / 2**20
response.remove_response_arr = remove_plain
Spectrum.fit_average_spectrum = fit_plain
if launches21 < 3 * N_EV:
    raise AssertionError(f"the response FFTs ran {launches21} times on the "
                         f"card for {N_EV} events (at least 3 each)")
# two events again on the CPU
err21_win, err21_mw = 0.0, 0.0
for e, (win_c, mw_c, star_c) in kept21.items():
    ev = mag.events[e]
    win_h = extract_windows(ev, device="cpu", **MAG_KW)
    spec_h = compute_moment_magnitude(ev, mag.network, windows=win_h,
                                      Q0=1e9, device="cpu")
    star_h = approximate_moment_magnitude(ev, mag.network, windows=win_h,
                                          Q0=1e9)
    for ph in ("noise", "p", "s"):
        err21_win = max(err21_win, float(np.abs(win_h[ph] - win_c[ph]).max()
                                         / np.abs(win_c[ph]).max()))
    err21_mw = max(err21_mw, abs(spec_h.Mw - mw_c), abs(star_h - star_c))
if err21_win > 1e-5 or err21_mw > 1e-3:
    raise AssertionError(f"card vs CPU: windows {err21_win:.3g} of their "
                         f"maximum (gate 1e-5), Mw/Mw* {err21_mw:.3g} "
                         "(gate 1e-3)")
# the JAX package's entry point, as it runs by default
t0 = time.perf_counter()
mws21 = workflow.compute_magnitudes(mag.events, mag.network)
cm21_s = time.perf_counter() - t0
if len(mws21) != N_EV:
    raise AssertionError(f"compute_magnitudes gave {len(mws21)} entries "
                         f"for {N_EV} events")
shutil.rmtree(mag_root)
r21 = np.array(rows21)
dmw = np.abs(r21[:, 1] - r21[:, 0])
dstar = np.abs(r21[:, 2] - r21[:, 0])
print(f"magnitude world: {len(mag.network.stations)} stations x 3 "
      f"components at 100 Hz, {len(mag.files)} INT32 miniSEED files of "
      f"{mag.n_samples} samples (4096-byte records) + "
      f"{len(mag.network.stations)} StationXML, {N_EV} events Mw "
      f"{mag.mw.min():.2f}-{mag.mw.max():.2f}: built in {world_s:.2f} s "
      f"(files written in {mag.write_sec:.2f} s); three windowed reads "
      f"equal to the whole decode + slice ({check21_s:.2f} s) [{CARD}]",
      flush=True)
for e, row in enumerate(rows21):
    print(f"  event {e}: Mw injected {row[0]:.3f}, fit {row[1]:.3f}, "
          f"Mw* {row[2]:.3f}; s: reads {row[3]:.3f}, response removal "
          f"{row[4]:.3f}, conditioning {row[5]:.3f}, spectra and "
          f"corrections {row[6]:.3f}, fit {row[7]:.3f}, Mw* {row[8]:.3f}",
          flush=True)
print(f"magnitude path on the card: {N_EV} events in {run21_s:.2f} s, "
      f"{N_EV / run21_s:.3f} events/s; reads {r21[:, 3].sum():.2f} s, "
      f"response removal {r21[:, 4].sum():.2f} s ({launches21} launches of "
      f"the response FFT on the card), spectra {r21[:, 6].sum():.2f} s, "
      f"fits {r21[:, 7].sum():.2f} s, Mw* {r21[:, 8].sum():.2f} s; "
      f"max |Mw - injected| {dmw.max():.3f} (gate 0.25), max |Mw* - "
      f"injected| {dstar.max():.3f} (gate 0.3); two events on the CPU: "
      f"windows within {err21_win:.2e} of their maximum, Mw/Mw* within "
      f"{err21_mw:.2e}; peak device memory {peak21:.1f} MiB above the "
      f"{held21 / 2**20:.0f} MiB held from earlier phases; "
      f"compute_magnitudes (counts integrated, the default route) "
      f"{cm21_s:.2f} s, {sum(m is not None for m in mws21)} of {N_EV} "
      f"values ({time.perf_counter() - t21:.1f} s) [{CARD}]", flush=True)
# 22. PhaseNet training on the card: the month script's picker
t22 = time.perf_counter()
t0 = time.perf_counter()
work23 = tempfile.mkdtemp(prefix="month_wf_")   # the days, both state files
month = build_month_world(work23)
x22, picks22 = training_windows(month.wavelet)
month_s = time.perf_counter() - t0
labels22 = gaussian_pick_labels(picks22, x22.shape[-1],
                                sigma=MONTH_TRAIN["sigma"])
LR22 = MONTH_TRAIN["learning_rate"]
# the first step on the card against the same step on the CPU: the seeded
# init that `train_phasenet` starts from, and its first batch
first22 = np.random.default_rng(0).permutation(len(x22))[
    :MONTH_TRAIN["batch_size"]]
step22 = {}
for dev22 in ("cpu", "cuda"):
    m22 = init_weights(PhaseNet(), torch.Generator().manual_seed(0)).to(dev22)
    o22 = torch.optim.Adam(m22.parameters(), lr=LR22)
    loss22 = make_train_step(m22, o22)(
        (torch.from_numpy(x22[first22]).to(dev22),
         torch.from_numpy(labels22[first22]).to(dev22)))
    step22[dev22] = (
        float(loss22),
        {n: p.grad.double().cpu() for n, p in m22.named_parameters()},
        {n: t.double().cpu() for n, t in m22.state_dict().items()
         if t.is_floating_point()})
del m22, o22
(loss_h, grad_h, sd_h), (loss_c, grad_c, sd_c) = step22["cpu"], step22["cuda"]


def adam_first(g):
    """Adam's first update from a gradient (optax's and torch's)."""
    return LR22 * g / (g.abs() + 1e-8)


g_scale22 = max(float(g.abs().max()) for g in grad_h.values())
err22_g = max(float((grad_c[n] - grad_h[n]).abs().max())
              for n in grad_h) / g_scale22
err22_w = max(float((sd_c[n] - sd_h[n]).abs().max()) for n in grad_h)
# the weights' difference is the one Adam's update makes of the two
# gradients (where |g| is near rounding noise, ~lr sign(g) flips), plus
# the f32 rounding of the weights
err22_u = max(float(((sd_c[n] - sd_h[n])
                     - (adam_first(grad_h[n]) - adam_first(grad_c[n])))
                    .abs().max()) for n in grad_h)
n22_flip = sum(int(((sd_c[n] - sd_h[n]).abs() > 1e-6).sum()) for n in grad_h)
err22_bn = max(float(((sd_c[n] - sd_h[n]).abs()
                      / sd_h[n].abs().clamp(min=1e-3)).max())
               for n in sd_h if "running_" in n)
if (abs(loss_c - loss_h) > 1e-5 or err22_g > 1e-4 or err22_u > 1e-6
        or err22_bn > 1e-4):
    raise AssertionError(
        f"training step card vs CPU: loss {loss_c} / {loss_h} (gate 1e-5), "
        f"gradients {err22_g:.3g} of the largest (gate 1e-4), weights "
        f"{err22_u:.3g} beyond Adam's update of the two gradients (gate "
        f"1e-6), running statistics {err22_bn:.3g} (gate 1e-4)")
# the script's training, through the tool's entry point
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
held22 = torch.cuda.memory_allocated()
t0 = time.perf_counter()
model22, losses22 = train_picker(month)
torch.cuda.synchronize()
train22_s = time.perf_counter() - t0
peak22 = (torch.cuda.max_memory_allocated() - held22) / 2**20
n_steps22 = MONTH_TRAIN["n_epochs"] * (len(x22) // MONTH_TRAIN["batch_size"])
if not losses22[-1] < losses22[0] or not np.isfinite(losses22).all():
    raise AssertionError(f"training: the loss did not fall: {losses22}")
# where a warm step's time goes: forward (with the loss), backward, Adam,
# CUDA events around each over 8 steps of a copy of the trained picker
m22 = copy.deepcopy(model22).train()
o22 = torch.optim.Adam(m22.parameters(), lr=LR22)
xb22 = torch.from_numpy(x22[first22]).cuda()
yb22 = torch.from_numpy(labels22[first22]).cuda()
ev22 = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for _ in range(9)]
with _ieee_convolutions():
    for e0, e1, e2, e3 in ev22:
        o22.zero_grad(set_to_none=True)
        e0.record()
        loss22 = cross_entropy_loss(m22(xb22), yb22)
        e1.record()
        loss22.backward()
        e2.record()
        o22.step()
        e3.record()
torch.cuda.synchronize()
split22 = np.mean([[a.elapsed_time(b) for a, b in zip(e[:-1], e[1:])]
                   for e in ev22[1:]], axis=0)   # the first is a warm-up
del m22, o22, xb22, yb22
# the checkpoint round trip: bit-equal probabilities on the card
ck22 = tempfile.mkdtemp(prefix="phasenet_ckpt_")
save_variables(ck22, model22)
back22 = PhaseNet().cuda()
load_variables(ck22, target=back22)
shutil.rmtree(ck22)
cut22 = month.day("day00")[:, :, :200_000]
pa22 = phasenet_probas_device(model22, cut22)
pb22 = phasenet_probas_device(back22, cut22)
if not torch.equal(pa22, pb22):
    raise AssertionError("checkpoint round trip: the probabilities differ "
                         f"by {float((pa22 - pb22).abs().max()):.3g}")
del back22, pa22, pb22
print(f"phasenet training (the month script's picker: {len(x22)} windows x "
      f"3 x {x22.shape[-1]}, {MONTH_TRAIN['n_epochs']} epochs, batch "
      f"{MONTH_TRAIN['batch_size']}, lr {LR22}, sigma "
      f"{MONTH_TRAIN['sigma']}; world and windows {month_s:.2f} s): first "
      f"step card vs CPU: loss {loss_c:.7f} / {loss_h:.7f}, gradients "
      f"within {err22_g:.3g} of the largest (gate 1e-4), weights within "
      f"{err22_w:.3g} ({n22_flip} beyond 1e-6), {err22_u:.3g} beyond Adam's "
      f"update of the two gradients (gate 1e-6), running statistics "
      f"{err22_bn:.3g} (gate 1e-4); losses "
      + " ".join(f"{v:.4f}" for v in losses22)
      + f"; {n_steps22} steps in {train22_s:.2f} s, "
      f"{1e3 * train22_s / n_steps22:.1f} ms a step (a warm step on CUDA "
      f"events: forward and loss {split22[0]:.2f} ms, backward "
      f"{split22[1]:.2f} ms, Adam {split22[2]:.2f} ms), "
      f"{n_steps22 * MONTH_TRAIN['batch_size'] / train22_s:.0f} windows/s; "
      f"peak device memory {peak22:.1f} MiB above the "
      f"{held22 / 2**20:.0f} MiB held; checkpoint round trip bit-equal on "
      f"10 x 3 x 200,000 samples ({time.perf_counter() - t22:.1f} s) "
      f"[{CARD}]", flush=True)

# 23. the month chain at full width over 3 days (BASELINE config 3): BP with
#     the trained picker's features -> a resume -> the bank from day 0 -> MF
#     at 'screen' -> the catalog, through the tool's entry points
t23 = time.perf_counter()
dates23 = dates_of(3)
state23 = {s: os.path.join(work23, f"{s}_state.json") for s in ("bp", "mf")}
ff23 = workflow.phasenet_feature_fn(model22)
bp_day_fn, mf_day_fn = workflow.backproject_day, workflow.matched_filter_day
days23 = {"bp": [], "mf": []}   # (date, kernel launches, other calls)
oracle23 = []                    # |CC - float64 oracle| of every detection
engines23 = {}                   # the campaigns' own Beamformer and engine


def counted_bp(data, *args, **kwargs):
    n0, p0 = bp.bp_beam.launches, bp.beamform_plain.calls
    out = bp_day_fn(data, *args, **kwargs)
    engines23["bp"] = out[0]
    days23["bp"].append((os.path.basename(data.where),
                         bp.bp_beam.launches - n0,
                         bp.beamform_plain.calls - p0))
    return out


def mf_others():
    return (mf.matched_filter_plain.calls + mf.mf_cc_highest.launches
            + mf.mf_cc_split.launches + mf.matched_filter_split_plain.calls)


def counted_mf(tg, data, *args, **kwargs):
    n0, p0 = mf.mf_cc.launches, mf_others()
    dets = mf_day_fn(tg, data, *args, **kwargs)
    days23["mf"].append((os.path.basename(data.where),
                         mf.mf_cc.launches - n0, mf_others() - p0))
    eng = engines23["mf"] = kwargs["mf"]
    for tid, evs in dets.items():
        if evs:
            tt = int(tg.tindexes[tid])
            idx = np.array([int(round((e.origin_time_epoch - data.date_epoch)
                                      * month.cfg.sampling_rate_hz))
                            for e in evs], np.int64)
            exact = matched_filter_at(tg.waveforms_arr[tt],
                                      tg.moveouts_arr[tt],
                                      eng.weights_channels[tt], eng.data_arr,
                                      idx)
            oracle23.append(float(np.abs(
                exact - np.array([e.aux_data["cc"] for e in evs])).max()))
    return dets


BP_STAGES = ("bp_features", "pn_normalize", "pn_forward", "bp_backproject",
             "bp_detect")
WORLD_STAGES = ("month_draw", "month_load")


def world_s(before):
    return ", ".join(f"{k} {GLOBAL_TIMER.times[k] - before[k]:.2f} s"
                     for k in WORLD_STAGES)


workflow.backproject_day, workflow.matched_filter_day = counted_bp, counted_mf
try:
    zero_counts()
    before23 = {k: GLOBAL_TIMER.times[k] for k in BP_STAGES + WORLD_STAGES}
    t0 = time.perf_counter()
    bp23 = bp_campaign(month, dates23[:2], ff23, state23["bp"])
    bp01_s = time.perf_counter() - t0
    st23 = {k: (GLOBAL_TIMER.times[k] - before23[k]) / 2 for k in BP_STAGES}
    # the same campaign over days 0-2 from the state file: day 2 only
    t0 = time.perf_counter()
    bp2_23 = bp_campaign(month, dates23, ff23, state23["bp"])
    bp2_s = time.perf_counter() - t0
    world23_bp = world_s(before23)
    if set(bp2_23) != {dates23[2]} or [d for d, _, _ in days23["bp"]] != \
            dates23:
        raise AssertionError(f"BP resume ran {sorted(bp2_23)}; days run "
                             f"{[d for d, _, _ in days23['bp']]}")
    bp23.update(bp2_23)
    t0 = time.perf_counter()
    bank23 = template_bank(month, bp23[dates23[0]])
    bank23_s = time.perf_counter() - t0
    scan0 = GLOBAL_TIMER.times["mf_scan"]
    before23 = {k: GLOBAL_TIMER.times[k] for k in WORLD_STAGES}
    t0 = time.perf_counter()
    mf23 = mf_campaign(month, dates23, bank23, state23["mf"])
    torch.cuda.synchronize()
    mf23_s = time.perf_counter() - t0
    scan23 = (GLOBAL_TIMER.times["mf_scan"] - scan0) / len(dates23)
    world23_mf = world_s(before23)
finally:
    workflow.backproject_day, workflow.matched_filter_day = (bp_day_fn,
                                                             mf_day_fn)
t0 = time.perf_counter()
cat23, n_cat23, n_uniq23 = catalog_of(mf23, bank23)
cat23_s = time.perf_counter() - t0
for stage, runs in days23.items():
    if [d for d, _, _ in runs] != dates23 or any(
            n < 1 or p for _, n, p in runs):
        raise AssertionError(f"month {stage}: (day, kernel launches, other "
                             f"calls) {runs}")
if max(oracle23, default=0.0) > ATOL_HIGHEST:
    raise AssertionError(f"month MF: a CC {max(oracle23):.3g} from the "
                         f"float64 oracle (gate {ATOL_HIGHEST})")
# every day's two events at their samples, through each template the bank
# kept at an injected event: at CC >= 0.99 where the template is the event
# itself; the other event's three misaligned channels (the script injects
# at int((t + tt) * sr) in float32, which puts one P and one S arrival one
# sample apart between the two times) bound its CC, held to the oracle
SR23 = month.cfg.sampling_rate_hz
ev_tp23 = {}
for tp in bank23.templates:
    dt = [abs(tp.origin_time_epoch - T0_EPOCH - t) for t in month.event_times]
    if min(dt) < 2.0:
        ev_tp23[str(tp.tid)] = (int(np.argmin(dt)), tp.origin_time_epoch
                                - T0_EPOCH - month.event_times[
                                    int(np.argmin(dt))])
if not ev_tp23:
    raise AssertionError(f"no template of the bank of {bank23.n_templates} "
                         "is at an injected event")
cc23 = {}
for date in dates23:
    for tid, (e0, bias) in ev_tp23.items():
        for e, t_ev in enumerate(month.event_times):
            hits = [ev for ev in mf23[date][tid]
                    if abs(ev.origin_time_epoch - T0_EPOCH - t_ev - bias)
                    < 0.5 / SR23]
            if len(hits) != 1 or (e == e0 and hits[0].aux_data["cc"] < 0.99):
                raise AssertionError(
                    f"{date}: template {tid} (event {e0}) at event {e}: "
                    + str([(h.origin_time_epoch - T0_EPOCH, h.aux_data["cc"])
                           for h in hits]))
            cc23.setdefault((tid, e == e0), []).append(hits[0].aux_data["cc"])
# the catalog: each event once as a unique event (the days share their
# stamp, so one event's detections on every day form one group)
for e, t_ev in enumerate(month.event_times):
    t_cat = [t_ev + bias for e0, bias in ev_tp23.values()]
    near = np.min(np.abs((cat23.origin_times_epoch - T0_EPOCH)[:, None]
                         - np.array(t_cat)[None]), axis=1) <= 3.0
    if int(np.sum(cat23["unique_event"][near])) != 1:
        raise AssertionError(f"catalog: event {e} has "
                             f"{int(np.sum(cat23['unique_event'][near]))} "
                             f"unique rows of {int(near.sum())}")
own23, other23 = ([f(c for (_, own), v in cc23.items() if own == side
                     for c in v) for f in (min, max)]
                  for side in (True, False))
launches23_bp = sum(n for _, n, _ in days23["bp"])
launches23_mf = sum(n for _, n, _ in days23["mf"])
# kernel #3 on the campaign's own plan (day 2's Beamformer) and a cut of
# day 2's trained-picker features around its first event, against the
# plain version
bf23 = engines23["bp"]
n23 = 100_000
a23 = int(month.event_times[0] * SR23) - n23 // 2
feat23 = ff23(month.make_data(dates23[2]).get_np_array(
    month.network.stations))
plan23c = bp.BeamformPlan(bf23.moveouts, bf23.weights_phases,
                          bf23.weights_sources, n23,
                          precision=bf23.precision, device=bf23.device)
g23c = plan23c.fold_and_pad(feat23[..., a23: a23 + n23])
kv23, ki23 = plan23c.call_folded(g23c)
pv23, pi23 = bp.beamform_plain(g23c, plan23c.tables)
err23_bp = float((kv23 - pv23[:n23]).abs().max())
near23 = check_first_max(plan23c.tables, g23c, kv23, ki23, pv23[:n23],
                         pi23[:n23], "month PhaseNet features")
errs_bp.append(err23_bp)
del feat23, g23c, kv23, ki23, pv23, pi23, plan23c
# kernel #1's default build on the MF campaign's own plan and the last
# day's padded upload as 'screen' made it (bf16-rounded), against the
# plain version on the same tensors
eng23 = engines23["mf"]
plans23 = list(eng23._plans.values())[-1]     # the last day's (LRU order)
dp23 = eng23._data_pad
if (not torch.equal(dp23, dp23.bfloat16().float())
        or sum(p.n_tp for p in plans23) != bank23.n_templates
        or any(p.precision_name != "default" for p in plans23)):
    raise AssertionError("month MF: the engine's last day is not the "
                         "'screen' upload of the whole bank")
err23_mf = 0.0
for plan23 in plans23:
    got23 = mf.mf_cc(dp23, plan23.filt_rows, plan23.mv_table,
                     plan23.tile_lo, n_tp=plan23.n_tp, L=plan23.L,
                     n_corr=plan23.n_corr_unit, lo_p=plan23.lo_p,
                     hi_p=plan23.hi_p, max_delta=plan23.max_delta)
    ref23 = plain_of(plan23, dp23)
    err23_mf = max(err23_mf, float((got23 - ref23).abs().max()))
    if not torch.allclose(got23, ref23, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"month MF: the default build != plain on "
                             f"the screen upload: max|diff| {err23_mf:.3g}")
del got23, ref23, dp23, plans23
# a warm BP day on the PhaseNet features under the profiler
with torch.profiler.profile(activities=acts) as prof23:
    t0 = time.perf_counter()
    bp_day(month, dates23[1], ff23)
    torch.cuda.synchronize()
    prof23_s = time.perf_counter() - t0
busy23, top23 = device_profile(prof23, "chip_smoke_month_profile.txt")
print(f"month chain ({len(month.network.stations)} stations x 3 x "
      f"{month.n_samples:,} samples a day, "
      f"{month.travel_times.n_sources} sources): BP days 0-1 "
      f"{bp01_s:.2f} s ({bp01_s / 2:.2f} s/day: "
      + ", ".join(f"{k} {v:.3f}" for k, v in st23.items())
      + f" s; the world over the 3 days: {world23_bp}), the resume over "
      f"days 0-2 ran day 2 only ({bp2_s:.2f} s); "
      f"BP detections {[len(bp23[d]) for d in dates23]}; bank of "
      f"{bank23.n_templates} templates from {len(bp23[dates23[0]])} "
      f"({bank23_s:.2f} s), {len(ev_tp23)} at an injected event; MF 3 days "
      f"{mf23_s:.2f} s ({mf23_s / 3:.2f} s/day, mf_scan {scan23:.3f} "
      f"s/day; the world: {world23_mf}), detections "
      f"{[sum(len(v) for v in mf23[d].values()) for d in dates23]}; "
      f"catalog {n_cat23} events, {n_uniq23} unique ({cat23_s:.2f} s); "
      f"launches a day: kernel #3 {[n for _, n, _ in days23['bp']]}, "
      f"kernel #1 {[n for _, n, _ in days23['mf']]}, 0 plain calls; the "
      f"events' CC: own {own23[0]:.4f}-{own23[1]:.4f}, other "
      f"{other23[0]:.4f}-{other23[1]:.4f}, "
      f"every detection's CC within {max(oracle23, default=0.0):.2e} of the "
      f"float64 oracle; kernel #3 on a {n23:,}-sample cut of day 2's "
      f"features through the campaign's plan vs plain: max|diff| "
      f"{err23_bp:.3g} (rtol={RTOL}, atol={ATOL}), first-max rule held, "
      f"{near23} samples with another source within {ATOL} of the maximum; "
      f"kernel #1's default build on day 2's screen upload through the "
      f"campaign's plan vs plain: max|diff| {err23_mf:.3g} (rtol={RTOL}, "
      f"atol={ATOL}); a warm BP day {prof23_s:.2f} s, device busy "
      f"{busy23:.1f} ms ({100 * busy23 / (1e3 * prof23_s):.0f}%): {top23} "
      f"({time.perf_counter() - t23:.1f} s) [{CARD}]", flush=True)

# 24. the year bank (BASELINE config 4) at full width: scripts/year_scan.py's
#     world and 1024-template bank, `scan_days` at 'screen' with a state file
t24 = time.perf_counter()
t0 = time.perf_counter()
year = build_year_world()
year_s = time.perf_counter() - t0
t0 = time.perf_counter()
bank24 = build_year_bank(year, N_YEAR)
_ = bank24.waveforms_arr, bank24.moveouts_arr
bank24_s = time.perf_counter() - t0
SR24, L24 = year.cfg.sampling_rate_hz, bank24.waveforms_arr.shape[-1]
N_CH24 = bank24.waveforms_arr.shape[1] * bank24.waveforms_arr.shape[2]
n_corr24 = year.n_samples - L24 + 1
noise24 = np.random.default_rng(SEED + 24).normal(size=500).astype(
    np.float32)
work24 = tempfile.mkdtemp(prefix="year_scan_")
state24 = os.path.join(work24, "year_state.json")
dates24 = year_dates(3)
YEAR_STAGES = ("mf_set_data", "mf_scan", "mf_refine", "mf_events")
runs24 = []         # (kernel launches, other calls) of each day
engines24 = []      # each campaign's own engine


def counted_mf24(tg, data, *args, **kwargs):
    n0, p0 = mf.mf_cc.launches, mf_others()
    dets = mf_day_fn(tg, data, *args, **kwargs)
    runs24.append((mf.mf_cc.launches - n0, mf_others() - p0))
    if not engines24 or engines24[-1] is not kwargs["mf"]:
        engines24.append(kwargs["mf"])
    return dets


def samples24(dets):
    """{tid: [(sample, CC)]} of one day's detections."""
    return {str(t): [(int(round((e.origin_time_epoch - T0_EPOCH) * SR24)),
                      float(e.aux_data["cc"])) for e in evs]
            for t, evs in dets.items()}


workflow.matched_filter_day = counted_mf24
try:
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    before24 = {k: GLOBAL_TIMER.times[k] for k in YEAR_STAGES}
    calls24 = GLOBAL_TIMER.counts["mf_set_data"]
    t0 = time.perf_counter()
    res24 = year_campaign(year, bank24, dates24[:2], state_file=state24,
                          white_noise=noise24)
    days24_s = (time.perf_counter() - t0) / 2
    st24 = {k: (GLOBAL_TIMER.times[k] - before24[k]) / 2
            for k in YEAR_STAGES}
    uploads24 = GLOBAL_TIMER.counts["mf_set_data"] - calls24
    plans24 = {k: [p.n_tp for p in v]
               for k, v in engines24[0]._plans.items()}
    # the same campaign over days 0-2 from the state file: day 2 only
    t0 = time.perf_counter()
    res24b = year_campaign(year, bank24, dates24, state_file=state24,
                           white_noise=noise24)
    day2_s = time.perf_counter() - t0
    peak24 = torch.cuda.max_memory_allocated() / 2**30
finally:
    workflow.matched_filter_day = mf_day_fn
launches24 = sum(n for n, _ in runs24)
if list(res24) != dates24[:2] or list(res24b) != dates24[2:]:
    raise AssertionError(f"year campaign ran {list(res24)}, then "
                         f"{list(res24b)} on resume")
if len(runs24) != 3 or any(n < 1 or p for n, p in runs24):
    raise AssertionError(f"year days: (kernel launches, other calls) "
                         f"{runs24}")
if uploads24 != 2 or len(plans24) != -(-N_YEAR // engines24[0]
                                       ._extraction_chunk(N_YEAR)):
    raise AssertionError(f"year campaign: {uploads24} day uploads over 2 "
                         f"days, plans {plans24}: the bank was not "
                         "uploaded once")
res24.update(res24b)
hits24 = {}
for date in dates24:
    day24 = samples24(res24[date])
    if sorted(day24, key=int) != [str(i) for i in range(N_YEAR)]:
        raise AssertionError(f"{date}: the detections' template ids are "
                             f"not 0-{N_YEAR - 1}")
    for tid, hits in day24.items():
        for t_ev in year.event_times:
            near = [i for i, _ in hits if abs(i - t_ev * SR24) <= 1]
            if len(near) != 1:
                raise AssertionError(f"{date}: template {tid} at the event "
                                     f"of {t_ev} s: {hits}")
    hits24[date] = sum(len(v) for v in day24.values())
# day 0 again: four 256-template sub-banks alone, and the whole bank with
# the extraction cut moved onto a 256 boundary
day0_24 = samples24(res24[dates24[0]])
row_gb24 = 4 * year.n_samples / 1024.0**3
t0 = time.perf_counter()
subs24 = {}
for lo in range(0, N_YEAR, 256):
    sub = TemplateGroup(bank24.templates[lo:lo + 256], year.network)
    subs24.update(samples24(year_campaign(
        year, sub, dates24[:1], white_noise=noise24)[dates24[0]]))
moved24 = samples24(year_campaign(
    year, bank24, dates24[:1], white_noise=noise24,
    max_memory_gb=512.5 * row_gb24)[dates24[0]])
checks24_s = time.perf_counter() - t0
for what, other in (("the 256-template sub-banks", subs24),
                    ("the moved extraction cut", moved24)):
    if other != day0_24:
        bad = [t for t in day0_24 if other.get(t) != day0_24[t]][:5]
        raise AssertionError(f"day 0 through {what} differs at templates "
                             f"{bad}")
# kernel #1's default build on day 2's upload through the year plan's first
# chunk, a 2^17-sample cut around the first event, against its plain version
eng24 = engines24[-1]
chunk24 = eng24._extraction_chunk(N_YEAR)
plans24b = list(eng24._plans.values())
dp24 = eng24._data_pad
if (not torch.equal(dp24, dp24.bfloat16().float())
        or [sum(p.n_tp for p in v) for v in plans24b]
        != [min(chunk24, N_YEAR - lo) for lo in range(0, N_YEAR, chunk24)]):
    raise AssertionError("year: the engine's last day is not the 'screen' "
                         "upload of the whole bank")
plan24 = plans24b[0][0]
n24 = 2**17
a24 = int(year.event_times[0] * SR24) - n24 // 2
dp24c = dp24[:, a24: a24 + plan24.pad_left + n24].contiguous()
call24 = dict(n_tp=plan24.n_tp, L=plan24.L, n_corr=n24 - plan24.L + 1,
              lo_p=plan24.lo_p, hi_p=plan24.pad_left + n24 - plan24.L)
got24 = mf.mf_cc(dp24c, plan24.filt_rows, plan24.mv_table, plan24.tile_lo,
                 max_delta=plan24.max_delta, **call24)
ref24 = mf.matched_filter_plain(dp24c, *mf.tf32_rows_parts(
    plan24.filt_rows, plan24.L), plan24.mv_table, **call24)
err24 = float((got24 - ref24).abs().max())
if not torch.allclose(got24, ref24, rtol=RTOL, atol=ATOL):
    raise AssertionError(f"year: the default build != plain on the year "
                         f"plan: max|diff| {err24:.3g}")
del got24, ref24, dp24c
all24 = [p for v in plans24b for p in v]
ms24 = cuda_ms(lambda: [p(dp24) for p in all24], 2)
# a warm day on the campaign's engine under the profiler
data24 = year.make_data(dates24[0])
with torch.profiler.profile(activities=acts) as prof24:
    t0 = time.perf_counter()
    workflow.matched_filter_day(bank24, data24, cfg=year.cfg, mf=eng24,
                                white_noise=noise24, **YEAR_DAY_KW)
    torch.cuda.synchronize()
    prof24_s = time.perf_counter() - t0
busy24, top24 = device_profile(prof24, "chip_smoke_year_profile.txt")
del data24, engines24, eng24, dp24, plans24b, all24, plan24
shutil.rmtree(work24)
gs24 = N_YEAR * N_CH24 * n_corr24 / days24_s / 1e9
quarter24 = (torch.cuda.mem_get_info()[1] / 4 / 2**30)
print(f"year bank ({N_YEAR} templates x {N_CH24} channels x "
      f"{year.n_samples:,} samples a day, screen): world {year_s:.1f} s, "
      f"bank {bank24_s:.1f} s; extraction chunk {chunk24} templates, plans "
      f"{list(plans24.values())}; days 0-1 {days24_s:.2f} s/day "
      f"({gs24:.2f} CC GSamples/s), the resume ran day 2 only "
      f"({day2_s:.2f} s, a new engine's plans included); stages s/day: "
      + ", ".join(f"{k} {v:.3f}" for k, v in st24.items())
      + f" (mf_set_data on the prefetch thread, mf_events the Event "
      f"building); detections a day {[hits24[d] for d in dates24]}, "
      f"every template at both events within a sample; kernel #1 "
      f"launches a day {[n for n, _ in runs24]}, 0 plain calls; day 0 "
      f"equal to the four 256-template sub-banks and to the extraction cut "
      f"at 512 ({checks24_s:.1f} s); peak device memory {peak24:.2f} GiB "
      f"({len(plans24)} extraction chunks queued, each sized so that its CC "
      f"stack ({chunk24 * row_gb24:.2f} GiB) and the extraction's "
      f"temporaries fit a quarter of memory, {quarter24:.1f} GiB); kernel "
      f"#1's "
      f"default build on a 2^17-sample cut of day 2 through the year "
      f"plan's first chunk vs plain: max|diff| {err24:.3g} (rtol={RTOL}, "
      f"atol={ATOL}); kernel #1 a day through the {N_YEAR}-template plans "
      f"{ms24:.2f} ms; a warm day {prof24_s:.2f} s, device busy "
      f"{busy24:.1f} ms ({100 * busy24 / (1e3 * prof24_s):.0f}%): {top24} "
      f"({time.perf_counter() - t24:.1f} s) [{CARD}]", flush=True)
del year, bank24, res24, res24b

# 25. the family path on the card: the month MF detections of one template
#     -> EventGroup -> SVDWF stack (batched SVD on the card) -> Stack ->
#     the family's P/S picks with phase 22's trained picker
t25 = time.perf_counter()
zero_counts()
tid25 = max(bank23.tids, key=lambda t: sum(len(mf23[d][t]) for d in dates23))
members25 = [ev for d in dates23 for ev in mf23[d][tid25]]
if len(members25) < 3:
    raise AssertionError(f"family: template {tid25} has "
                         f"{len(members25)} detections (3 needed)")
SR25 = month.cfg.sampling_rate_hz
t0 = time.perf_counter()
group25 = EventGroup(members25, month.network)
group25.read_waveforms(FAMILY_WIN, offset_phase=FAMILY_OFFSETS)
group25.get_waveforms_arr()
group25.normalize("rms")
read25_s = time.perf_counter() - t0
t0 = time.perf_counter()
stack25 = group25.SVDWF_stack(2.0, 8.0, SR25)
torch.cuda.synchronize()
svd25_ms = 1e3 * (time.perf_counter() - t0)
svd_launches25 = stacking.svdwf_panels.launches
wf25 = group25.waveforms_arr
panels25 = np.moveaxis(wf25, 0, 2).reshape(-1, wf25.shape[0],
                                           wf25.shape[-1])
panels25 = panels25[[p for p in range(len(panels25))
                     if not np.allclose(panels25[p], 0.0)]]
card25 = stacking.svdwf_panels(panels25, freqmin=2.0, freqmax=8.0,
                               sampling_rate=SR25)
host25 = stacking.svdwf_panels_host(panels25, freqmin=2.0, freqmax=8.0,
                                    sampling_rate=SR25)
err25 = float(np.abs(card25 - host25).max() / np.abs(host25).max())
if svd_launches25 < 1 or err25 > 1e-9:
    raise AssertionError(f"family: svdwf on the card {svd_launches25} "
                         f"launches, {err25:.3g} from the host float64 "
                         f"version (gate 1e-9 of its maximum)")
stack25.read_waveforms(FAMILY_WIN)
if stack25.get_np_array().shape != wf25.shape[1:] or not np.isfinite(
        stack25.get_np_array()).all():
    raise AssertionError("family: the stack's windows are not finite")
for ev in members25:
    del ev.traces   # the picker reads each member around its origin
t0 = time.perf_counter()
picks25 = stack25.pick_PS_phases_family_mode(
    FAMILY_PICK_SEC, make_picker(model22), picker_sampling_rate=SR25,
    offset_ot=FAMILY_OFFSET_OT, threshold_P=FAMILY_THRESHOLD,
    threshold_S=FAMILY_THRESHOLD)
torch.cuda.synchronize()
pick25_s = time.perf_counter() - t0
# the injected arrivals, in samples from each member's window start (the
# member's origin less offset_ot), averaged over the family
tt25 = {ph: np.array([month.travel_times.travel_times[ph][s][
    month.event_src] for s in month.network.stations], np.float64)
    for ph in ("P", "S")}      # seconds
err_picks25 = {}
for ph in ("P", "S"):
    want = np.zeros(len(month.network.stations))
    for ev in members25:
        t_ev = min(month.event_times, key=lambda t: abs(
            ev.origin_time_epoch - T0_EPOCH - t))
        want += (T0_EPOCH + t_ev + tt25[ph]
                 - (ev.origin_time_epoch - FAMILY_OFFSET_OT)) * SR25
    want /= len(members25)
    err_picks25[ph] = picks25[f"{ph}_picks"] - want
print(f"family picks - injected arrivals (samples): P "
      f"{np.round(err_picks25['P'], 1).tolist()}, S "
      f"{np.round(err_picks25['S'], 1).tolist()}", flush=True)
for ph in ("P", "S"):
    n_ok = int(np.sum(np.abs(err_picks25[ph]) <= FAMILY_PICK_TOL[ph]))
    if n_ok < FAMILY_MIN_STATIONS[ph]:
        raise AssertionError(f"family: {ph} picks within "
                             f"{FAMILY_PICK_TOL[ph]} samples of the injected "
                             f"arrivals at {n_ok} stations")
# the same family picked again with the picker on the CPU (float64 Z-scores
# and f32 forwards there too): the same picks within rtol 1e-4
for ev in members25:
    del ev.traces
picks25c = stack25.pick_PS_phases_family_mode(
    FAMILY_PICK_SEC, make_picker(copy.deepcopy(model22).cpu()),
    picker_sampling_rate=SR25, offset_ot=FAMILY_OFFSET_OT,
    threshold_P=FAMILY_THRESHOLD, threshold_S=FAMILY_THRESHOLD)
err25c = 0.0
for c in picks25.columns:
    a, b = picks25[c], picks25c[c]
    if not np.array_equal(np.isnan(a), np.isnan(b)) or not np.allclose(
            a[~np.isnan(a)], b[~np.isnan(b)], rtol=RTOL, atol=RTOL):
        raise AssertionError(f"family: the card's {c} {a} != the CPU's {b}")
    err25c = max(err25c, float(np.nanmax(np.abs(a - b), initial=0.0)))
stack25.picks_table = picks25
shutil.rmtree(work23)
print(f"family path on the card: template {tid25}'s {len(members25)} month "
      f"detections -> EventGroup ({wf25.shape}, {read25_s:.2f} s to read) "
      f"-> SVDWF_stack {svd25_ms:.1f} ms a family ({len(panels25)} panels, "
      f"{svd_launches25} batched SVD launch on the card, within "
      f"{err25:.3g} of the host float64 version's maximum, gate 1e-9) -> "
      f"Stack.read_waveforms -> pick_PS_phases_family_mode with phase 22's "
      f"picker {pick25_s:.2f} s (tolerances {FAMILY_PICK_TOL} samples at "
      f"{FAMILY_MIN_STATIONS} stations held), the same picks as the "
      f"picker's on the CPU within {err25c:.3g} "
      f"({time.perf_counter() - t25:.1f} s) [{CARD}]", flush=True)

# 26. the sharded MF day: phase 4's world on virtual meshes of the card
t26 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
CARD0 = torch.device("cuda", torch.cuda.current_device())
MESHES26 = {"2x4": make_mesh({"tp": 2, "time": 4}, devices=[CARD0] * 8),
            "3x5": make_mesh({"tp": 3, "time": 5}, devices=[CARD0] * 15)}
w26 = np.full((N_TP, N_STA, N_COMP), 1.0 / (N_STA * N_COMP), np.float32)
RUNG26 = {"default": mf.mf_cc, "highest": mf.mf_cc_highest,
          "high": mf.mf_cc_split}
errs26, lines26 = {}, []
for rung, wrapper in RUNG26.items():
    plan26 = mf.MatchedFilterPlan(tg.waveforms_arr, tg.moveouts_arr, w26,
                                  N_SAMP, precision=rung)
    dp26 = plan26.pad_data(DAYS["d1"])
    want26 = plan26(dp26)
    unsharded_ms = cuda_ms(lambda: plan26(dp26), 3)
    errs26[rung] = 0.0
    for name, mesh26 in MESHES26.items():
        sp26 = sharded.ShardedMatchedFilterPlan(
            tg.waveforms_arr, tg.moveouts_arr, w26, N_SAMP, mesh26,
            precision=rung)
        sd26 = sp26.pad_data(DAYS["d1"])
        n0 = wrapper.launches
        got26 = sp26(sd26)
        n_launch26 = wrapper.launches - n0
        torch.cuda.synchronize()
        if not torch.equal(got26, want26):
            raise AssertionError(
                f"sharded {rung} on {name} != unsharded kernel: max|diff| "
                f"{float((got26 - want26).abs().max()):.3g}")
        grid26, lay26 = sp26.grid, sp26.layout
        shards26 = [(a, t) for a, _, _ in sp26.shards
                    for t in range(lay26.n_t) if sp26.n_lags(t)]
        if n_launch26 != len(shards26):
            raise AssertionError(f"sharded {rung} on {name}: {n_launch26} "
                                 f"launches for {len(shards26)} shards")
        sharded_ms = cuda_ms(lambda: sp26(sd26), 3)
        chunks26 = sharded._scatter(torch.from_numpy(
            DAYS["d1"].reshape(N_STA * N_COMP, N_SAMP)), grid26, lay26)
        halo_ms = cuda_ms(lambda: sharded._exchange(chunks26, grid26, lay26),
                          5)
        del chunks26
        line = (f"{rung} {name}: {n_launch26} launches, day {sharded_ms:.2f} "
                f"ms sharded / {unsharded_ms:.2f} unsharded, halos "
                f"{halo_ms:.3f} ms")
        if name == "2x4":
            per26 = [cuda_ms(lambda: sp26.shard_cc(sd26, a, t), 3)
                     for a, t in shards26]
            line += (", per shard " + "/".join(f"{x:.2f}" for x in per26)
                     + " ms")
            # the last time shard of template shard 1 (the day's end, its
            # lag bounds moved by its base) against the rung's plain version
            a, t = 1, lay26.n_t - 1
            p26 = sp26.plans[(a, grid26[a, t])]
            base = t * lay26.chunk
            ext26 = sd26.ext(t, grid26[a, t])
            kw26 = dict(n_tp=p26.n_tp, L=L, n_corr=sp26.n_lags(t),
                        lo_p=p26.lo_p - base, hi_p=p26.hi_p - base)
            if rung == "high":
                ref26 = mf.matched_filter_split_plain(
                    ext26, *mf.split_rows_parts(p26.filt_rows, L),
                    p26.mv_table, **kw26)
            else:
                ref26 = mf.matched_filter_plain(
                    ext26, *mf.tf32_rows_parts(p26.filt_rows, L),
                    p26.mv_table, **kw26)
            k26 = sp26.shard_cc(sd26, a, t)
            torch.cuda.synchronize()
            errs26[rung] = float((k26 - ref26).abs().max())
            if not torch.allclose(k26, ref26, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"sharded {rung}: shard ({a}, {t}) != "
                                     f"plain: max|diff| {errs26[rung]:.3g}")
            line += f", shard ({a}, {t}) vs plain {errs26[rung]:.3g}"
            del ref26, k26
        lines26.append(line)
        del got26, sd26, sp26
    del plan26, dp26, want26
print("sharded MF kernels, phase 4's bank and day 1 (128 x 30 x 2,160,000) "
      "on virtual meshes of the card, each equal to the unsharded kernel "
      "bit for bit: " + "; ".join(lines26) + f" [{CARD}]", flush=True)


def mf_samples(res):
    return {d: {t: sorted(round(e.origin_time_epoch * SR) for e in evs)
                for t, evs in r.items() if evs} for d, r in res.items()}


scan26 = {}
for name, mesh26 in MESHES26.items():
    before = GLOBAL_TIMER.times["mf_scan"]
    zero_counts()
    res26 = workflow.scan_days(list(DATES), make_data, tg, cfg=cfg, mesh=mesh26,
                               **dict(kw, rng=np.random.default_rng(SEED + 2)))
    n_launch = mf.mf_cc.launches
    if (n_launch < 2 * 8 or mf.matched_filter_plain.calls
            or mf.mf_cc_highest.launches or mf.mf_cc_split.launches):
        raise AssertionError(f"sharded screen campaign ({name}): {n_launch} "
                             f"launches, plain calls "
                             f"{mf.matched_filter_plain.calls}")
    if mf_samples(res26) != mf_samples(results):
        raise AssertionError(f"sharded screen campaign ({name}): the "
                             f"detections differ from phase 4's")
    scan26[name] = ((GLOBAL_TIMER.times["mf_scan"] - before) / len(DATES),
                    n_launch)
launches26 = sum(n for _, n in scan26.values())
peak26 = torch.cuda.max_memory_allocated() / 2**30
# a warm sharded 'screen' day (2 x 4) under torch.profiler
eng26 = MatchedFilter(tg, cfg=cfg, precision="screen", mesh=MESHES26["2x4"],
                      **{k: v for k, v in kw.items()
                         if k != "minimum_interevent_time"})
workflow.matched_filter_day(tg, day1, cfg=cfg, mf=eng26,
                            minimum_interevent_time=5.0)   # plans, warm-up
with torch.profiler.profile(activities=acts) as prof26:
    t0 = time.perf_counter()
    workflow.matched_filter_day(tg, day1, cfg=cfg, mf=eng26,
                                minimum_interevent_time=5.0)
    torch.cuda.synchronize()
    prof26_s = time.perf_counter() - t0
busy26, top26 = device_profile(prof26, "chip_smoke_sharded_mf_profile.txt")
print(f"sharded scan_days screen over phase 4's two days: detections "
      f"identical to phase 4's ({n_det}); s/day "
      + ", ".join(f"{k} {s:.3f} ({n} launches)" for k, (s, n) in scan26.items())
      + f" beside phase 4's {scan_s:.3f}; a warm 2 x 4 day {prof26_s:.3f} s, "
      f"device busy {busy26:.1f} ms ({100 * busy26 / (1e3 * prof26_s):.0f}%): "
      f"{top26}; peak {peak26:.2f} GiB ({time.perf_counter() - t26:.1f} s) "
      f"[{CARD}]", flush=True)
del res26, eng26

# 27. the sharded BP day: phase 8's lattice world on virtual meshes
t27 = time.perf_counter()
torch.cuda.reset_peak_memory_stats()
MESHES27 = {"2x4": make_mesh({"src": 2, "time": 4}, devices=[CARD0] * 8),
            "3x5": make_mesh({"src": 3, "time": 5}, devices=[CARD0] * 15)}
feat27 = saturated_envelopes(BP_DAYS["d1"])[0]
plan27 = bp.BeamformPlan(mv_bp, w_ph_bp, w_src_bp, N_SAMP)
wv27, wi27 = plan27(feat27)
unsharded27 = cuda_ms(lambda: plan27(feat27), 2)
lines27, errs27 = [], []
for name, mesh27 in MESHES27.items():
    sp27 = sharded.ShardedBeamformPlan(mv_bp, w_ph_bp, w_src_bp, N_SAMP,
                                       mesh27)
    gd27 = sp27.fold_and_pad(feat27)
    n0 = bp.bp_beam.launches
    gv27, gi27 = sp27.call_folded(gd27)
    n_launch27 = bp.bp_beam.launches - n0
    torch.cuda.synchronize()
    if not (torch.equal(gv27, wv27) and torch.equal(gi27, wi27)):
        raise AssertionError(f"sharded bp on {name} != unsharded kernel")
    grid27, lay27 = sp27.grid, sp27.layout
    shards27 = [(a, t) for a, _, _ in sp27.shards for t in range(lay27.n_t)
                if sp27.tile_range(t)[1]]
    sharded27 = cuda_ms(lambda: sp27.call_folded(gd27), 2)
    g27 = fold_components(feat27, plan27.weights_phases)
    chunks27 = sharded._scatter(g27, grid27, lay27)
    halo27 = cuda_ms(lambda: sharded._exchange(chunks27, grid27, lay27), 5)
    del chunks27, g27
    line = (f"{name}: {n_launch27} launches for {len(shards27)} shards, day "
            f"{sharded27:.2f} ms sharded / {unsharded27:.2f} unsharded, "
            f"halos {halo27:.3f} ms")
    if name == "2x4":
        per27 = [cuda_ms(lambda: sp27.shard_beam(gd27, a, t), 2)
                 for a, t in shards27]
        line += ", per shard " + "/".join(f"{x:.2f}" for x in per27) + " ms"
        # the day's last 200 time tiles in source shard 1's last time shard,
        # from that shard's own columns, against the plain version
        a, t = 1, lay27.n_t - 1
        tab27 = sp27.tables[(a, grid27[a, t])]
        ext27 = gd27.ext(t, grid27[a, t])
        tile0 = max(sp27.tile_range(t)[0], sp27.n_t_blocks - 200)
        kw27 = dict(tile0=tile0, n_tt=sp27.n_t_blocks - tile0,
                    origin=t * lay27.chunk)
        kv, ki = bp.bp_beam(ext27, tab27, **kw27)
        pv, pi = bp.beamform_plain(ext27, tab27, **kw27)
        sel = torch.arange(kv.numel(), device=kv.device)
        sel = sel[kw27["tile0"] * bp.TIME_TILE + sel < N_SAMP]
        errs27.append(float((kv[sel] - pv[sel]).abs().max()))
        near27 = check_first_max(tab27, ext27[:, kw27["tile0"] * bp.TIME_TILE
                                             - kw27["origin"]:],
                                 kv[sel], ki[sel], pv[sel], pi[sel],
                                 "sharded, the day's end")
        line += (f", the day's last 200 tiles of shard ({a}, {t}) vs plain "
                 f"{errs27[-1]:.3g} ({near27} ties within {ATOL})")
        del kv, ki, pv, pi
    lines27.append(line)
    del gd27, gv27, gi27, sp27
del plan27, wv27, wi27
# a tie across source shards: source 90,000 (the last source shard of both
# meshes) made an exact copy of 12,345 (the first), and a spike at sample
# 60,000 for them on a 2^17 cut: the smaller index must win
TIE27 = (BP_EVENTS["d1"][0][1], N_SRC_BP * 9 // 10)   # 12,345, 90,000
mv_tie, w_tie = mv_bp.copy(), w_src_bp.copy()
mv_tie[TIE27[1]], w_tie[TIE27[1]] = mv_bp[TIE27[0]], w_src_bp[TIE27[0]]
feat_tie = feat27[..., : 2**17].clone()
for s in np.flatnonzero(w_src_bp[TIE27[0]]):
    feat_tie[s, 2, 60_000 + mv_bp[TIE27[0], s, 0]] += 50.0
    feat_tie[s, :2, 60_000 + mv_bp[TIE27[0], s, 1]] += 50.0
tv, ti = bp.BeamformPlan(mv_tie, w_ph_bp, w_tie, 2**17)(feat_tie)
for name, mesh27 in MESHES27.items():
    sv, si = sharded.beamform_sharded_pallas(feat_tie, mv_tie, w_ph_bp,
                                             w_tie, mesh27)
    if not (torch.equal(sv, tv) and torch.equal(si, ti)
            and int(si[60_000]) == TIE27[0]
            and not bool((si == TIE27[1]).any())):
        raise AssertionError(f"sharded bp tie ({name}): sample 60,000 went "
                             f"to {int(si[60_000])}")
# reduce='none' on a cut: 3,000 sources x 2^14 samples
n27n, cut27 = 2**14, slice(0, 3000)
want27n = bp.beamform(feat27[..., :n27n], mv_bp[cut27], w_ph_bp,
                      w_src_bp[cut27], reduce="none")
for name, mesh27 in MESHES27.items():
    got27n = sharded.beamform_sharded_pallas(
        feat27[..., :n27n], mv_bp[cut27], w_ph_bp, w_src_bp[cut27], mesh27,
        reduce="none")
    if not torch.equal(got27n, want27n):
        raise AssertionError(f"sharded bp none ({name}) != unsharded")
del want27n, got27n, feat_tie, feat27
print("sharded BP kernel, phase 8's world (100,000 sources x 64 "
      "station-phases x 2,160,000 samples, day 1's envelopes) on virtual "
      "meshes of the card, (max, argmax) equal to the unsharded kernel's bit "
      "for bit: " + "; ".join(lines27) + "; a tie across source shards to the "
      "smaller index, reduce='none' on 3,000 sources x 2^14 equal "
      f"[{CARD}]", flush=True)


def bp_hits(res):
    return {d: sorted((round(e.origin_time_epoch * SR),
                       e.aux_data["source_index"]) for e in evs)
            for d, evs in res.items()}


stages27 = ("bp_features", "bp_backproject", "bp_detect")
launches27_all = 0
for name, mesh27 in MESHES27.items():
    before = {k: GLOBAL_TIMER.times[k] for k in stages27}
    zero_counts()
    res27 = workflow.scan_days(["d1"], make_bp_data, cfg=cfg_bp, stage="bp",
                               network=net_bp, travel_times=travel,
                               mesh=mesh27)
    launches27 = bp.bp_beam.launches
    if launches27 < 8 or bp.beamform_plain.calls:
        raise AssertionError(f"sharded bp campaign ({name}): {launches27} "
                             f"launches, {bp.beamform_plain.calls} plain")
    launches27_all += launches27
    if bp_hits(res27)["d1"] != bp_hits(res_bp)["d1"]:
        raise AssertionError(f"sharded bp campaign ({name}): the detections "
                             f"differ from phase 8's")
    scan27 = {k: GLOBAL_TIMER.times[k] - before[k] for k in stages27}
    print(f"sharded scan_days bp ({name}), day 1: {len(res27['d1'])} "
          f"detections identical to phase 8's; s/day "
          + ", ".join(f"{k} {v:.3f}" for k, v in scan27.items())
          + " beside phase 8's "
          + ", ".join(f"{v:.3f}" for v in stage_s.values())
          + f"; {launches27} launches [{CARD}]", flush=True)
peak27 = torch.cuda.max_memory_allocated() / 2**30
# a warm sharded BP day (2 x 4) under torch.profiler
bf27 = Beamformer(network=net_bp, phases=["P", "S"], travel_times=travel,
                  cfg=cfg_bp, mesh=MESHES27["2x4"])
day27 = make_bp_data("d1")
workflow.backproject_day(day27, net_bp, travel, cfg=cfg_bp, bf=bf27)
with torch.profiler.profile(activities=acts) as prof27:
    t0 = time.perf_counter()
    workflow.backproject_day(day27, net_bp, travel, cfg=cfg_bp, bf=bf27)
    torch.cuda.synchronize()
    prof27_s = time.perf_counter() - t0
busy27, top27 = device_profile(prof27, "chip_smoke_sharded_bp_profile.txt")
print(f"sharded bp: a warm 2 x 4 day {prof27_s:.3f} s, device busy "
      f"{busy27:.1f} ms ({100 * busy27 / (1e3 * prof27_s):.0f}%): {top27}; "
      f"phase 27 peak {peak27:.2f} GiB ({time.perf_counter() - t27:.1f} s) "
      f"[{CARD}]", flush=True)
del res27, bf27, day27

# 28. the command line on the card: `python -m seismic_bpmf_tpu_torch info`
#     as a subprocess, then the CLI's runners (`cli.run_<command>`, what
#     each `cmd_<command>` runs after its file loaders) on the in-memory
#     worlds of phases 4 and 8: this machine has no h5py, so the loaders
#     are held to the JAX CLI on the CPU (tests/test_torch_cli.py)
t28 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
proc28 = subprocess.run(
    [sys.executable, "-m", "seismic_bpmf_tpu_torch", "info"],
    capture_output=True, text=True, cwd=HERE, timeout=300,
    env=dict(os.environ, PYTHONPATH=HERE))
if proc28.returncode:
    raise AssertionError(f"cli info: rc {proc28.returncode}: "
                         f"{proc28.stderr[-2000:]}")
info28 = json.loads(proc28.stdout)
if (info28["backend"] != "cuda"
        or torch.cuda.get_device_name(0) not in info28["devices"]):
    raise AssertionError(f"cli info: {info28}")
parser28 = cli.build_parser()
work28 = tempfile.mkdtemp(prefix="cli_")
captured28 = {}


def captured(name):
    """`workflow.<name>`, keeping what its last call returned."""
    fn = getattr(workflow, name)

    def call(*args, **kwargs):
        captured28[name] = fn(*args, **kwargs)
        return captured28[name]
    return fn, call


def run_cli(name, runner, argv, *objects):
    """(stdout, host seconds, stage seconds) of one runner call, with
    `workflow.<name>` wrapped to keep its result."""
    fn, call = captured(name)
    setattr(workflow, name, call)
    before = dict(GLOBAL_TIMER.times)
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = runner(parser28.parse_args(argv), *objects)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(workflow, name, fn)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: rc {rc}")
    return (out.getvalue(), wall,
            {k: v - before.get(k, 0.0) for k, v in GLOBAL_TIMER.times.items()
             if v != before.get(k, 0.0)})


# backproject: phase 8's world, day 1, through kernel #3
zero_counts()
day28 = make_bp_data("d1")
out28, bp28_s, bp28_st = run_cli(
    "backproject_day", cli.run_backproject,
    ["backproject", "--data", "memory/d1", "--network", "-",
     "--travel-times", "-"], cfg_bp, net_bp, day28, travel)
launches28_bp = bp.bp_beam.launches
if launches28_bp < 1 or bp.beamform_plain.calls:
    raise AssertionError(f"cli backproject: {launches28_bp} launches, "
                         f"{bp.beamform_plain.calls} plain")
dets28 = captured28["backproject_day"][1]
if out28.split()[0] != str(len(dets28)):
    raise AssertionError(f"cli backproject printed {out28!r}")
hits28 = sorted((round(e.origin_time_epoch * SR), e.aux_data["source_index"])
                for e in dets28)
if hits28 != bp_hits(res_bp)["d1"]:
    raise AssertionError("cli backproject: the detections differ from "
                         "phase 8's day 1")
del day28
# matched-filter at `high`: phase 4's bank and day 1, through kernel #2
zero_counts()
mf_flags = ["--min-channels", "6", "--min-stations", "3", "--max-kurto",
            "1e6", "--min-interevent-time", "5"]
out28, mf28_s, mf28_st = run_cli(
    "matched_filter_day", cli.run_matched_filter,
    ["matched-filter", "--data", "memory/d1", "--network", "-",
     "--templates", "-", "--precision", "high", *mf_flags],
    cfg, make_data("d1"), tg)
launches28_mf = mf.mf_cc_split.launches
if (launches28_mf < 1 or mf.mf_cc.launches or mf.mf_cc_highest.launches
        or mf.matched_filter_split_plain.calls):
    raise AssertionError(f"cli matched-filter: {launches28_mf} split "
                         f"launches; others {mf.mf_cc.launches}, "
                         f"{mf.mf_cc_highest.launches}, "
                         f"{mf.matched_filter_split_plain.calls}")
det28 = captured28["matched_filter_day"]
for day, tid, o in REPEATS:
    if day != "d1":
        continue
    t_exp = T0_EPOCH + o / SR
    hits = [e for e in det28[str(tid)]
            if abs(e.origin_time_epoch - t_exp) < 0.5 / SR]
    if not hits or hits[0].aux_data["cc"] < 0.99:
        raise AssertionError(f"cli matched-filter: repeat of template {tid} "
                             f"at sample {o} not detected with CC >= 0.99")
n28_mf = sum(len(v) for v in det28.values())
# scan: phase 4's two days at `screen` with a state file, then a resume
zero_counts()
state28 = os.path.join(work28, "state.json")
scan_argv = ["scan", "--data", *DATES, "--network", "-", "--templates", "-",
             "--state", state28, *mf_flags]
out28, scan28_s, scan28_st = run_cli("scan_days", cli.run_scan, scan_argv,
                                     cfg, tg, list(DATES), make_data)
launches28_scan = mf.mf_cc.launches
if (launches28_scan < len(DATES) or mf.mf_cc_split.launches
        or mf.mf_cc_highest.launches or mf.matched_filter_plain.calls):
    raise AssertionError(f"cli scan: {launches28_scan} launches of kernel "
                         f"#1's default build; others "
                         f"{mf.mf_cc_split.launches}, "
                         f"{mf.mf_cc_highest.launches}, "
                         f"{mf.matched_filter_plain.calls}")
res28 = captured28["scan_days"]
for day, tid, o in REPEATS:
    t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
    hits = [e for e in res28[day][str(tid)]
            if abs(e.origin_time_epoch - t_exp) < 0.5 / SR]
    if not hits or hits[0].aux_data["cc"] < 0.99:
        raise AssertionError(f"cli scan: repeat of template {tid} at sample "
                             f"{o} of {day} not detected with CC >= 0.99")
with open(state28) as f:
    if sorted(json.load(f)) != sorted(DATES):
        raise AssertionError("cli scan: the state file lacks a day")
zero_counts()
again28, _, _ = run_cli("scan_days", cli.run_scan, scan_argv, cfg, tg,
                        list(DATES), make_data)
if ("0 new detections over 0 days" not in again28
        or mf.mf_cc.launches):
    raise AssertionError(f"cli scan resume: {again28!r}, "
                         f"{mf.mf_cc.launches} launches")
# catalog: the scan's detections -> CSV -> `Catalog.read`
csv28 = os.path.join(work28, "catalog.csv")
out28, cat28_s, _ = run_cli(
    "assemble_catalog", cli.run_catalog,
    ["catalog", "--network", "-", "--templates", "-", "--db", "-",
     "--output", csv28],
    tg, {tid: [e for day in DATES for e in res28[day][tid]]
         for tid in res28["d1"]})
cat28 = Catalog.read(csv28)
if cat28.n_events != captured28["assemble_catalog"].n_events:
    raise AssertionError("cli catalog: the CSV lost rows")
for day, tid, o in REPEATS:
    t_exp = T0_EPOCH + DAY_SEC * (int(day[1:]) - 1) + o / SR
    rows = np.flatnonzero(
        (np.abs(cat28.origin_times_epoch - t_exp) < 0.5 / SR)
        & (cat28["tid"].astype(int).astype(str) == str(tid)))
    if len(rows) != 1 or not cat28["unique_event"][rows[0]]:
        raise AssertionError(f"cli catalog: repeat of template {tid} at "
                             f"sample {o} of {day} is not one unique event")
shutil.rmtree(work28)
scan28_day = scan28_st["mf_scan"] / len(DATES)
print(f"cli on the card: info {info28['backend']} {info28['devices']}; "
      f"backproject day 1 {bp28_s:.3f} s ("
      + ", ".join(f"{k} {bp28_st.get(k, 0.0):.3f}" for k in stages27)
      + f"; phase 8 s/day " + ", ".join(f"{v:.3f}" for v in stage_s.values())
      + f"), {len(dets28)} detections = phase 8's, {launches28_bp} launches "
      f"of kernel #3; matched-filter high {mf28_s:.3f} s (mf_scan "
      f"{mf28_st['mf_scan']:.3f}; phase 11 {scan11_s:.3f}), {n28_mf} "
      f"detections, every day-1 repeat, {launches28_mf} launches of kernel "
      f"#2; scan screen {scan28_s:.3f} s over {len(DATES)} days (mf_scan "
      f"{scan28_day:.3f} s/day; phase 4 {scan_s:.3f}), {launches28_scan} "
      f"launches of kernel #1, every repeat, resume scans 0 days; catalog "
      f"{cat28_s:.2f} s, {cat28.n_events} rows, "
      f"{int(cat28['unique_event'].sum())} unique "
      f"({time.perf_counter() - t28:.1f} s) [{CARD}]", flush=True)

# 29. `train_phasenet(mesh=)`: phase 22's training on virtual meshes of the
#     card, the batch split over {"data": 4} and {"data": 3}; then a warm
#     step at the script's batch unsharded and on 4 shards (one CUDA graph
#     a step): its ms and its launches (torch.profiler's runtime rows)
t29 = time.perf_counter()
cuda0 = torch.device("cuda", torch.cuda.current_device())
MESHES29 = {n: make_mesh({"data": n}, devices=[cuda0] * n) for n in (4, 3)}
step29 = {}
for n29, mesh29 in MESHES29.items():
    nb29 = MONTH_TRAIN["batch_size"] // n29 * n29
    xb29 = torch.from_numpy(x22[first22[:nb29]]).cuda()
    yb29 = torch.from_numpy(labels22[first22[:nb29]]).cuda()
    out29 = []
    for sharded in (False, True):
        m29 = init_weights(PhaseNet(),
                           torch.Generator().manual_seed(0)).cuda()
        o29 = torch.optim.Adam(m29.parameters(), lr=LR22)
        st29 = (make_sharded_train_step(m29, o29, mesh29) if sharded
                else make_train_step(m29, o29))
        loss29 = float(st29((xb29, yb29)))
        out29.append((loss29, {k: p.grad.double().cpu()
                               for k, p in m29.named_parameters()},
                      {k: t.double().cpu() for k, t in m29.state_dict().items()
                       if t.is_floating_point()}))
    (l_u, g_u, s_u), (l_s, g_s, s_s) = out29
    g_scale = max(float(g.abs().max()) for g in g_u.values())
    err_g = max(float((g_s[k] - g_u[k]).abs().max()) for k in g_u) / g_scale
    err_u = max(float(((s_s[k] - s_u[k])
                       - (adam_first(g_u[k]) - adam_first(g_s[k])))
                      .abs().max()) for k in g_u)
    err_bn = max(float(((s_s[k] - s_u[k]).abs()
                        / s_u[k].abs().clamp(min=1e-3)).max())
                 for k in s_u if "running_" in k)
    step29[n29] = (nb29, abs(l_s - l_u), err_g, err_u, err_bn)
    if (abs(l_s - l_u) > 1e-5 or err_g > 1e-4 or err_u > 1e-6
            or err_bn > 1e-4):
        raise AssertionError(
            f"sharded step ({n29} shards) vs unsharded on the card: loss "
            f"{l_s} / {l_u} (gate 1e-5), gradients {err_g:.3g} of the "
            f"largest (gate 1e-4), weights {err_u:.3g} beyond Adam's update "
            f"of the two gradients (gate 1e-6), running statistics "
            f"{err_bn:.3g} (gate 1e-4)")
del m29, o29, xb29, yb29
# the month script's training on the 4-shard mesh beside phase 22's
torch.cuda.synchronize()
t0 = time.perf_counter()
_, _, losses29 = train_phasenet(x22, picks22, seed=0, verbose=False,
                                mesh=MESHES29[4], **MONTH_TRAIN)
torch.cuda.synchronize()
train29_s = time.perf_counter() - t0
rel29 = max(abs(a - b) / abs(b) for a, b in zip(losses29, losses22))
if len(losses29) != len(losses22) or rel29 > 1e-3:
    raise AssertionError(f"sharded training: losses {losses29} against "
                         f"phase 22's {losses22} (gate 1e-3 relative)")
nb29 = MONTH_TRAIN["batch_size"] // 4 * 4
b29 = (torch.from_numpy(x22[first22[:nb29]]).cuda(),
       torch.from_numpy(labels22[first22[:nb29]]).cuda())
warm29 = {}
for where in ("unsharded", "4 shards"):
    m29 = init_weights(PhaseNet(), torch.Generator().manual_seed(0)).cuda()
    o29 = torch.optim.Adam(m29.parameters(), lr=LR22)
    st29 = (make_sharded_train_step(m29, o29, MESHES29[4])
            if where == "4 shards" else make_train_step(m29, o29))
    ms29 = wall_ms(lambda: st29(b29), [cuda0], 10)
    warm29[where] = (ms29, step_profile(st29, b29, [cuda0])["launches"])
del m29, o29, st29, b29
print(f"sharded training: first step against the unsharded on the card, "
      + "; ".join(f"{n} shards (batch {v[0]}): loss {v[1]:.3g}, gradients "
                  f"{v[2]:.3g} of the largest, weights {v[3]:.3g} beyond "
                  f"Adam's update, running statistics {v[4]:.3g}"
                  for n, v in step29.items())
      + f"; the month training on 4 shards: losses "
      + " ".join(f"{v:.4f}" for v in losses29)
      + f" (within {rel29:.3g} relative of phase 22's), {n_steps22} steps "
      f"in {train29_s:.2f} s, {1e3 * train29_s / n_steps22:.1f} ms a step "
      f"(phase 22: {1e3 * train22_s / n_steps22:.1f}); a warm step of "
      f"{nb29}: " + ", ".join(f"{k} {v[0]:.2f} ms, {v[1]:g} launches"
                              for k, v in warm29.items())
      + f" ({time.perf_counter() - t29:.1f} s) [{CARD}]", flush=True)

# 30. `profile_trace` around a warm 'screen' day: in a fresh process, whose
#     trace must hold kernel #1's row, and here on phase 4's bank and day 1,
#     whose rows are counted only (a process that has kept the card busy for
#     minutes loses device rows from its torch.profiler traces: PERF.md
#     section 6); then examples/synthetic_day_torch.py as a subprocess
TRACE30 = """
import sys
import numpy as np
import torch
from seismic_bpmf_tpu_torch import workflow
from seismic_bpmf_tpu_torch.config import Config
from seismic_bpmf_tpu_torch.data import Data, Stream, TemplateGroup, Trace
from seismic_bpmf_tpu_torch.detection import MatchedFilter
from seismic_bpmf_tpu_torch.utils.observe import profile_trace

SR, N_TP, N_STA, L, N = 25.0, 128, 10, 200, 2_160_000
rng = np.random.default_rng(0)
day = rng.standard_normal((N_STA, 3, N), dtype=np.float32)
stations = [f"ST{s:02d}" for s in range(N_STA)]
tg = TemplateGroup.from_arrays(
    rng.normal(size=(N_TP, N_STA, 3, L)).astype(np.float32),
    rng.integers(-50, 300, size=(N_TP, N_STA, 3)),
    [str(i) for i in range(N_TP)], stations, sampling_rate=SR,
    locations=np.zeros((N_TP, 3)))


def reader(where, starttime=None, endtime=None, **kwargs):
    st = Stream()
    for s, sta in enumerate(stations):
        for c, comp in enumerate("NEZ"):
            st += Trace(day[s, c], station=sta, network="XX",
                        channel=f"HH{comp}", sampling_rate=SR,
                        starttime=1343260800.0)
    return st


cfg = Config(sampling_rate_hz=SR, template_len_sec=L / SR)
data = Data("2012-07-26", "memory/day", reader, duration=N / SR,
            sampling_rate=SR).read_waveforms()
engine = MatchedFilter(tg, cfg=cfg, precision="screen", max_kurto=1e6,
                       rng=np.random.default_rng(1))
for trace_dir in (None, sys.argv[1]):       # a warm-up day, the traced day
    with profile_trace(trace_dir):
        workflow.matched_filter_day(tg, data, cfg=cfg, mf=engine,
                                    minimum_interevent_time=5.0)
        torch.cuda.synchronize()
"""


def trace_rows(logdir):
    """(trace files, events, device rows, kernel #1's rows) of the one
    Chrome trace `profile_trace` wrote under `logdir` (then removed)."""
    files = os.listdir(logdir)
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(logdir)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return (len(files), len(events), len(dev),
            sum("mf_kernel" in e.get("name", "") for e in dev))


t30 = time.perf_counter()
fresh30 = tempfile.mkdtemp(prefix="trace_")
proc30 = subprocess.run([sys.executable, "-c", TRACE30, fresh30],
                        capture_output=True, text=True, cwd=HERE, timeout=600,
                        env=dict(os.environ, PYTHONPATH=HERE))
if proc30.returncode:
    raise AssertionError(f"profile_trace in a fresh process: rc "
                         f"{proc30.returncode}: {proc30.stderr[-2000:]}")
rows30 = trace_rows(fresh30)
if rows30[0] != 1 or rows30[3] != 1:
    raise AssertionError(f"profile_trace in a fresh process: {rows30[0]} "
                         f"files, {rows30[2]} device rows, {rows30[3]} of "
                         f"kernel #1")
screen30 = MatchedFilter(tg, cfg=cfg, precision="screen",
                         **{k: v for k, v in kw.items()
                            if k != "minimum_interevent_time"})
workflow.matched_filter_day(tg, day1, cfg=cfg, mf=screen30,
                            minimum_interevent_time=5.0)   # plans, warm-up
here30 = tempfile.mkdtemp(prefix="trace_")
with profile_trace(here30):
    workflow.matched_filter_day(tg, day1, cfg=cfg, mf=screen30,
                                minimum_interevent_time=5.0)
    torch.cuda.synchronize()
rows30_here = trace_rows(here30)
del screen30
ex30 = subprocess.run(
    [sys.executable, os.path.join(HERE, "examples",
                                  "synthetic_day_torch.py")],
    capture_output=True, text=True, cwd=HERE, timeout=600,
    env=dict(os.environ, PYTHONPATH=HERE))
if (ex30.returncode
        or "OK: all injected events recovered" not in ex30.stdout):
    raise AssertionError(f"synthetic_day_torch: rc {ex30.returncode}: "
                         f"{ex30.stdout[-1500:]} {ex30.stderr[-1500:]}")
print(f"profile_trace of a warm screen day: a fresh process {rows30[1]} "
      f"trace events, {rows30[2]} device rows, {rows30[3]} of kernel #1; "
      f"this process ({time.perf_counter() - T_START:.0f} s old) "
      f"{rows30_here[1]} events, {rows30_here[2]} device rows, "
      f"{rows30_here[3]} of kernel #1; synthetic_day_torch: "
      + " | ".join(line for line in ex30.stdout.splitlines()
                   if line.startswith("["))
      + f"; OK ({time.perf_counter() - t30:.1f} s) [{CARD}]", flush=True)

# 31. the port's benchmark program in fresh processes: the CLI's `bench
#     --check`, the default run (its extras to a temporary file), `--bp` on
#     a 20 s budget and `--phasenet`; each exits 0 with a JSON line last
#     whose value is above 0
t31 = time.perf_counter()
torch.cuda.empty_cache()
extras31 = os.path.join(tempfile.mkdtemp(prefix="bench_"), "extras.json")
log31 = os.path.join(HERE, "chiprun_out", "chip_smoke_bench.txt")
os.makedirs(os.path.dirname(log31), exist_ok=True)
for argv31 in (["-m", "seismic_bpmf_tpu_torch", "bench", "--check"],
               ["bench_torch.py", "--extras", extras31],
               ["bench_torch.py", "--bp", "--budget-s", "20"],
               ["bench_torch.py", "--phasenet"]):
    t = time.perf_counter()
    proc31 = subprocess.run([sys.executable, *argv31], capture_output=True,
                            text=True, cwd=HERE, timeout=600,
                            env=dict(os.environ, PYTHONPATH=HERE))
    with open(log31, "a") as f:
        f.write(f"$ python3 {' '.join(argv31)}  [{CARD}]\n{proc31.stderr}"
                f"{proc31.stdout}\n")
    try:
        result31 = json.loads(proc31.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        result31 = {}
    if proc31.returncode or not result31.get("value", 0) > 0:
        raise AssertionError(f"python3 {' '.join(argv31)}: rc "
                             f"{proc31.returncode}: {proc31.stdout[-1500:]}"
                             f" {proc31.stderr[-2500:]}")
    for line in proc31.stderr.splitlines():
        if line.startswith("#"):
            print(f"  {line}", flush=True)
    print(f"bench_torch {' '.join(argv31[1:])}: {json.dumps(result31)} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
with open(extras31) as f:
    extras31_got = json.load(f)
shutil.rmtree(os.path.dirname(extras31))
if (sorted(extras31_got) != ["beamform", "mf_extraction", "mf_screen",
                             "phasenet"]
        or not all(r["value"] > 0 for r in extras31_got.values())):
    raise AssertionError(f"bench_torch extras: {extras31_got}")
print(f"bench_torch: four runs and four extras OK "
      f"({time.perf_counter() - t31:.1f} s) [{CARD}]", flush=True)

# 32. the native host scans (csrc/host_ops.cpp, built by the C++
# compiler) against their NumPy versions: MF's host route (the overflow or
# `anomalous_cdf` case) on a whole day's CC, the catalog dedup, the source
# grid's redundancy scan
t32 = time.perf_counter()
t0 = time.perf_counter()
if not host_ops.available():
    raise AssertionError("the host library did not build")
build32 = time.perf_counter() - t0
times32 = {}


def both32(name, *args, **kwargs):
    """(native, plain) results of host scan `name`, timed."""
    out = []
    for fn in (getattr(host_ops, name), getattr(host_ops, name + "_plain")):
        t0 = time.perf_counter()
        out.append(fn(*args, **kwargs))
        times32.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
    if not np.array_equal(out[0], out[1]):
        raise AssertionError(f"native {name} != its NumPy version: "
                             f"{np.flatnonzero(out[0] != out[1])[:10]}")
    return out[0]


# one template's whole-day CC at 'screen' (kernel #1's default build on the
# bf16-rounded upload), its RMS threshold and the engine's margin and
# search window (detection/matched_filter.py `select_cc_indexes`)
eng32 = MatchedFilter(tg, cfg=cfg, precision="screen",
                      **{k: v for k, v in kw.items()
                         if k != "minimum_interevent_time"})
# what find_detections sets (its defaults; phase 4's interevent time), and
# the one field of the day that _search_win reads
eng32.minimum_interevent_time = kw["minimum_interevent_time"]
eng32.threshold_window_dur, eng32.overlap = 1800.0, 0.25
eng32.data = SimpleNamespace(sr=SR)
T32 = 3
plan32 = mf.MatchedFilterPlan(
    tg.waveforms_arr[[T32]], tg.moveouts_arr[[T32]],
    np.full((1, N_STA, N_COMP), 1.0 / (N_STA * N_COMP), np.float32), N_SAMP,
    precision="default")
cc32 = plan32(plan32.pad_data(DAYS["d1"], dtype="bfloat16"))[0].cpu().numpy()
thr32 = time_dependent_threshold(
    torch.from_numpy(cc32), int(eng32.threshold_window_dur * SR),
    cfg.n_dev_mf_threshold, overlap=eng32.overlap,
    threshold_type=eng32.threshold_type,
    white_noise=np.random.default_rng(SEED + 32).standard_normal(500)
    .astype(np.float32)).numpy()
win32 = eng32._search_win(T32)
sel32 = both32("select_cc_indexes", cc32, thr32, int(win32))
cand32 = np.flatnonzero(cc32 > thr32 - eng32._margin())
kept32 = both32("dedup_detection_indexes", cand32, cc32, win32)
if not (sel32.any() and len(kept32)):
    raise AssertionError(f"host scans found nothing on template {T32}'s day")
# phase 23's catalog, its bank's distance and CC tables
flags32 = both32(
    "flag_multiples", cat23.origin_times_epoch,
    np.array([bank23.tindexes.get(t, -1) for t in cat23["tid"].astype(str)],
             np.int64),
    cat23["cc"], dist=bank23.ellipsoid_distances,
    ccm=bank23.intertemplate_cc)
# phase 8's lattice: 100,000 sources x 64 station-phase moveouts (samples),
# 10 x 10 cells; every source compared on its 10 smallest differences
lon32 = (W7.src_km[:, 0] / KM_PER_DEG).astype(np.float32)
lat32 = (W7.src_km[:, 1] / KM_PER_DEG).astype(np.float32)
edges32 = np.linspace(0.0, 100.0 / KM_PER_DEG + 1e-6, 11)
mv32 = W7.mv.reshape(N_SRC_BP, -1).astype(np.float32)
red32 = both32("find_similar_sources", mv32, lon32, lat32,
               edges32, edges32, 2.0, num_stations_for_diff=10,
               method="smallest")
# 'closest' (the default method) on the lattice's first 10,000 sources (its
# NumPy sweep of all 100,000 takes ~10 min), the moveouts as they are: bit
# for bit, the ties at the 10th smallest moveout (integer samples) broken
# by station index as the NumPy version's stable argsort breaks them
N32C = 10_000
args32c = (lon32[:N32C], lat32[:N32C], edges32, edges32, 2.0)
kw32c = dict(num_stations_for_diff=10, method="closest")
redc32 = both32("find_similar_sources", mv32[:N32C], *args32c, **kw32c)
times32["find_similar_sources 'closest'"] = times32[
    "find_similar_sources"][2:]
del times32["find_similar_sources"][2:]
kth32 = np.sort(mv32[:N32C], axis=1)[:, 9:11]
tied32 = int((kth32[:, 0] == kth32[:, 1]).sum())
if not tied32:
    raise AssertionError("no source of the lattice ties at its 10th "
                         "moveout: the tie order goes unchecked")
print(f"host scans, native (built in {build32:.2f} s) against NumPy, bit "
      f"for bit: select_cc_indexes on template {T32}'s 'screen' day "
      f"({len(cc32):,} samples, window {win32:g}) {int(sel32.sum())} "
      f"triggers; dedup_detection_indexes {len(cand32)} -> {len(kept32)}; "
      f"flag_multiples on phase 23's catalog {int(flags32.sum())} of "
      f"{len(flags32)} unique; find_similar_sources (smallest 10 of "
      f"{mv32.shape[1]}) on "
      f"phase 8's {N_SRC_BP:,} sources {int(red32.sum()):,} redundant; "
      f"'closest' (10 of {mv32.shape[1]}) on its first {N32C:,} as they "
      f"are ({tied32} tied at the 10th moveout), {int(redc32.sum()):,} "
      f"redundant; ms native / "
      "NumPy: " + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.1f}"
                            for k, v in times32.items())
      + f" ({time.perf_counter() - t32:.1f} s) [{CARD}]", flush=True)
del cc32, thr32, plan32, eng32, mv32

launches_dense = launches18 + launches19
print(f"chip_smoke: {time.perf_counter() - T_START:.0f} s, phases 15-16 "
      f"{t16 - t15:.0f} s, phases 17-20 {t21 - t16:.0f} s, phase 21 "
      f"{t22 - t21:.0f} s, phase 22 {t23 - t22:.0f} s, phase 23 "
      f"{t24 - t23:.0f} s, phase 24 {t25 - t24:.0f} s, phase 25 "
      f"{t26 - t25:.0f} s, phase 26 {t27 - t26:.0f} s, phase 27 "
      f"{t28 - t27:.0f} s, phase 28 {t29 - t28:.0f} s, phase 29 "
      f"{t30 - t29:.0f} s, phase 30 {t31 - t30:.0f} s, phase 31 "
      f"{t32 - t31:.0f} s, phase 32 {time.perf_counter() - t32:.0f} s",
      flush=True)

print(CARD)
print(json.dumps({"kernels": [{
    "name": "mf_cc",
    "route": "cuda",
    "source": "seismic_bpmf_tpu_torch/csrc/mf.cu",
    "replaces": "seismic_bpmf_tpu/ops/pallas_mf.py:120",
    "launches": (launches + launches23_mf + launches24 + launches26
                 + launches28_scan),
    "max_abs_err": max(err5d, err3d, err23_mf, err24, errs26["default"]),
    "ms": ms5d,
    "plain_ms": plain_ms,
    "bound_ms": bound_ms,
    "bound_by": bound_by,
    "library_ms": None,
}, {
    "name": "mf_cc_highest",
    "route": "cuda",
    "source": "seismic_bpmf_tpu_torch/csrc/mf.cu",
    "replaces": "seismic_bpmf_tpu/ops/pallas_mf.py:120",
    "launches": launches5,
    "max_abs_err": max(err, err3, err13_f32, errs26["highest"]),
    "ms": ms,
    "plain_ms": plain_ms,
    "bound_ms": bound_ms,
    "bound_by": bound_by,
    "library_ms": None,
}, {
    "name": "mf_cc_split",
    "route": "cuda",
    "source": "seismic_bpmf_tpu_torch/csrc/mf_split.cu",
    "replaces": "seismic_bpmf_tpu/ops/pallas_mf.py:285",
    "launches": launches11 + launches28_mf,
    "max_abs_err": max(err10, err12, err13, errs26["high"]),
    "ms": ms13,
    "plain_ms": plain13,
    "bound_ms": bound13,
    "bound_by": bound_by13,
    "library_ms": None,
}, {
    "name": "bp_beam",
    "route": "cuda",
    "source": "seismic_bpmf_tpu_torch/csrc/bp.cu",
    "replaces": "seismic_bpmf_tpu/ops/pallas_bp.py:67",
    "launches": (launches_bp + launches_dense + launches23_bp
                 + launches27_all + launches28_bp),
    "max_abs_err": max(errs_bp + errs27),
    "ms": ms_bp,
    "plain_ms": plain_ms_bp,
    "bound_ms": bound_bp,
    "bound_by": bound_by_bp,
    "library_ms": None,
}]}))
print(json.dumps({"ok": True, "device": {
    "platform": "gpu", "kind": torch.cuda.get_device_name(0),
    "count": torch.cuda.device_count()}}))
