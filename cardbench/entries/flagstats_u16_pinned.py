"""One report through ``libflagstats_tpu_torch.flagstats_u16`` on the
column held in page-locked host memory (the traffic's ``holds``:
``pinned``), held to the ``flagstat`` reference. Set-up pins one int16
tensor of the column's length and copies the column into it once; a
report is one call on the whole tensor with the program's default impl.
On the CPU (the program's device ``"cpu"``), which has no page-locked
memory, the tensor is a plain CPU tensor."""
import torch

REFERENCE = "flagstat"


def make(data, setup):
    import libflagstats_tpu_torch as lft

    holds = setup.traffic["holds"]
    if holds != "pinned":
        raise ValueError(f"unknown holds {holds!r}")
    words = torch.empty(data.shape[0], dtype=torch.int16, pin_memory=data.device.type == "cuda")
    words.copy_(data)
    print(f"held {words.shape[0]} words on the host, pinned {words.is_pinned()}", file=setup.log)
    device = setup.program_device
    return (lambda: lft.flagstats_u16(words, device=device)), words
