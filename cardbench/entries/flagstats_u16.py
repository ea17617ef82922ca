"""One report through ``libflagstats_tpu_torch.flagstats_u16``, held to
the ``flagstat`` reference. The traffic's ``holds`` says where the
caller holds the column: ``card``, the tensor as made, or ``host``, a
pageable numpy copy. A report is one call on the whole column or, with
``block_words``, one accumulating call a block (upstream's ``-D``:
FLAGSTATS_u16 per block), each block call inside a host-clock span
``block_call``."""
import time

import numpy as np

REFERENCE = "flagstat"


def make(data, setup):
    import libflagstats_tpu_torch as lft

    holds = setup.traffic["holds"]
    if holds == "card":
        words = data
    elif holds == "host":
        words = data.cpu().numpy().view(np.uint16)
    else:
        raise ValueError(f"unknown holds {holds!r}")
    device = setup.program_device
    block = setup.traffic.get("block_words")
    if not block:
        return (lambda: lft.flagstats_u16(words, device=device)), words
    blocks = [words[s:s + block] for s in range(0, len(words), block)]
    calls = setup.probe.spans.setdefault("block_call", [])
    clock = time.perf_counter

    def report():
        acc = np.zeros(32, dtype=np.uint64)
        for b in blocks:
            t = clock()
            lft.flagstats_u16(b, out=acc, device=device)
            calls.append(clock() - t)
        return acc

    return report, words
