"""How late the window's stalled jobs run, in ms a job: over the window's
untraced full-length jobs, the mean of their `sim.run_ensemble` spans'
durations minus the median. The spans come from the port's in-process
buffer (`utils.profiling.spans()`), since the profiler sees one job of the
window; full-length jobs are those of `steps` equal to the traced work's,
which leaves out the set-up's job, and the traced job is the one that
overlaps the traced stretch, whose window shares the spans' clock
(`time.time_ns()`). A program without the buffer reads nothing."""
import statistics


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    try:
        from pyqg_generative_torch.utils import profiling
        records = profiling.spans()
    except (ImportError, AttributeError):
        return None
    lo, hi = (w * 1e3 for w in ctx.trace.window)  # us -> ns
    jobs = [(r.end_ns - r.start_ns) / 1e6 for r in records
            if r.name == "sim.run_ensemble"
            and r.attrs.get("steps") == ctx.work["steps"]
            and not (r.start_ns < hi and r.end_ns > lo)]
    if len(jobs) < 2:
        return None
    return statistics.fmean(jobs) - statistics.median(jobs)
