"""Per cent of its roofline that the hypotheses launch of RANSAC reaches: the operation bound
of one launch (``roofline/ransac_score.py`` at ``peaks.py``'s rates)
over the mean own duration of its launches in the trace (by kernel name).
None where no launch of that name ran."""

from slambench import peaks, spec


def read(ctx):
    roof = spec.load_module("roofline", "ransac_score")
    d = ctx["trace"].kernel_durations_s(roof.KERNEL)
    if not d:
        return None
    return 100.0 * peaks.bound_s(*roof.counts(ctx["cfg"])) / (sum(d) / len(d))
