"""What the program files under each campaign day: the stages' seconds and
the meters that `utils.observe.GLOBAL_TIMER` keeps a day, in its
`day_spans` ({day: {stage: [seconds, self seconds, calls]}}) and
`day_meters` ({day: {meter: value}}), read for the window's days.

`workflow.scan_days` files a day under `str(date)`, and `window.py` hands
it the dates `d<day, six digits>`.  A reader returns None, never 0, where
the program keeps no such records (as before they were added) or a window
day has no record of what it reads."""

from __future__ import annotations

SECONDS, SELF_SECONDS = 0, 1


def _window_records(run, book: str):
    """Each window day's record in the timer's `book`, or None."""
    from seismic_bpmf_tpu_torch.utils.observe import GLOBAL_TIMER

    records = getattr(GLOBAL_TIMER, book, None)
    if not records or not run.n_days:
        return None
    days = [records.get(f"d{i:06d}") for i in run.record.days]
    return None if any(d is None for d in days) else days


def stage_per_day(run, stage: str, column: int = SECONDS):
    """Seconds a window day in `stage` (`column` SELF_SECONDS: less the
    stages inside it), or None."""
    days = _window_records(run, "day_spans")
    if days is None or any(stage not in d for d in days):
        return None
    return sum(d[stage][column] for d in days) / len(days)


def meter_total(run, meter: str):
    """The meter's total over the window's days, or None."""
    days = _window_records(run, "day_meters")
    if days is None or any(meter not in d for d in days):
        return None
    return sum(d[meter] for d in days)
