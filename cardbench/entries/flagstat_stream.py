"""One report through ``libflagstats_tpu_torch.flagstat_stream`` over the
configuration's framed file (its ``frames``), with the benchmark's
section timer as ``timer=``. The file is written in set-up from a host
copy of the column; the ``flagstat`` reference reads that copy, never
the file."""
import numpy as np

from cardbench import frames

REFERENCE = "flagstat"


def make(data, setup):
    import libflagstats_tpu_torch as lft

    words = data.cpu().numpy().view(np.uint16)
    spec = setup.config["frames"]
    f, path = frames.temp_file()
    setup.stack.enter_context(f)
    info = frames.write_frames(words, spec, f.fileno())
    print(f"file {info}", file=setup.log)
    timer, device = setup.probe.timer, setup.program_device
    return (lambda: lft.flagstat_stream(path, spec["codec"], timer=timer, device=device)), words
