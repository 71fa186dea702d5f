"""Host ms a train call spends in the program's ``chain.draws`` span
(``Distiller._replay``: each step's and microbatch's host draws, their
pinned copies and their copies to the graph's static tensors), over the
profiled stretch's calls. Prints the replay's other staging spans beside
it."""

import sys

from benchmark import program

STAGING = ("chain.batches", "chain.lrs", "chain.draws", "chain.launch")


def read(r):
    if r.kind != "train":
        return None
    ms = {name: program.span_ms(r.stretch, [name]) for name in STAGING}
    if ms["chain.draws"] is not None:
        print("replay staging, host ms a call: "
              + ", ".join(f"{k} {v!r}" for k, v in ms.items()), file=sys.stderr)
    return ms["chain.draws"]
