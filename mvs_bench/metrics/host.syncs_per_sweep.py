"""Host synchronisations a sweep: the program's count of synchronising CUDA
calls while the traced run's timer is attached to the window's sweeps
(``dpe_mvs_tpu_torch.utils.profiling.SYNCS``, summed over its spans), over
the window's sweeps. None where the program keeps no such count."""
LAYER = "host synchronisations"
MOVES = "mpix_per_s"


def read(ctx):
    from dpe_mvs_tpu_torch.utils import profiling
    syncs = getattr(profiling, "SYNCS", None)
    if not ctx["sweeps"] or not syncs:
        return None
    return sum(syncs.values()) / ctx["sweeps"]
