"""The share of the frames served that are padding: 100 x (1 -
``valid_frames`` / ``served_frames``), the program's counters' change over
the profiled stretch (``UpstreamExpert.forward``: each call's rows x the
padded frame count, and each row's own frames, from the host's lengths).
None where the program keeps no such counters."""

from benchmark import program


def read(r):
    if r.kind != "serve":
        return None
    served = program.counted(r.stretch, "served_frames")
    valid = program.counted(r.stretch, "valid_frames")
    if not served or valid is None:
        return None
    return 100.0 * (1.0 - valid / served)
