"""Per cent of its roofline that guided map matching's kernel reaches: the
bound of one launch (``roofline/guided_match.py`` at ``peaks.py``'s rates)
over the mean own duration of its launches in the trace (by kernel name).
None where no launch of that name ran."""

from slambench import peaks, spec


def read(ctx):
    roof = spec.load_module("roofline", "guided_match")
    d = ctx["trace"].kernel_durations_s(roof.KERNEL)
    if not d:
        return None
    return 100.0 * peaks.bound_s(*roof.counts(ctx["cfg"])) / (sum(d) / len(d))
