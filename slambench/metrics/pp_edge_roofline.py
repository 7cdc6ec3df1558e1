"""Per cent of its roofline that the pose-pose edge kernel of the
Gauss-Newton iterations reaches: the bound of one launch
(``roofline/pp_edge.py`` at ``peaks.py``'s rates) over the mean own
duration of its launches in the trace (by kernel name). None where no
launch of that name ran."""

from slambench import peaks, spec


def read(ctx):
    roof = spec.load_module("roofline", "pp_edge")
    d = ctx["trace"].kernel_durations_s(roof.KERNEL)
    if not d:
        return None
    return 100.0 * peaks.bound_s(*roof.counts(ctx["cfg"])) / (sum(d) / len(d))
