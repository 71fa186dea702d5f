"""Host milliseconds of a call, from the call to its return, before
anything waits for the card; the mean over the traced run's window calls
outside the profiled stretch.

train: ``Distiller.train_step_chain`` (K steps): staging the batches, the
  learning rates and the draws, and enqueuing the replay; only calls made
  with the card's queue empty (the window's first and the first after each
  read of the logs, every ``log_every`` steps) count, since later calls
  wait for room in the card's command queue, which times the card.
serve: ``UpstreamExpert.forward``: the numpy padding, the copy to the card
  and the enqueue."""

import statistics


def read(r):
    return statistics.fmean(r.host_ms) if r.host_ms else None
