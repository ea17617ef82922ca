"""One report through ``libflagstats_tpu_torch.flagstat_sharded`` over the
column held as shards, held to the ``flagstat_shards`` reference.

The traffic's ``shards`` says how many and ``holds`` where: ``cards``,
shard i resident on card i. The shards are the column's contiguous
ranges of ``shard_bounds(n, shards)``. Shard 0 is a clone of its range on
the card the column was made on and the others are copies on their own
cards, so the whole column is freed once set-up ends. On the CPU (the
program's device ``"cpu"``) the shards stay on the CPU. A report is one
call on the list of shards, with the program's default impl."""
import torch

REFERENCE = "flagstat_shards"


def make(data, setup):
    import libflagstats_tpu_torch as lft
    from libflagstats_tpu_torch.parallel import shard_bounds

    k, holds = setup.traffic["shards"], setup.traffic["holds"]
    if holds != "cards":
        raise ValueError(f"unknown holds {holds!r}")
    n = data.shape[0]
    if data.device.type == "cpu":
        devices = [data.device] * k
    else:
        if torch.cuda.device_count() < k:
            raise RuntimeError(f"the traffic holds {k} shards on {k} cards; "
                               f"{torch.cuda.device_count()} found")
        devices = [torch.device("cuda", i) for i in range(k)]
    shards = [data[a:b].clone() if dev == data.device else data[a:b].to(dev)
              for dev, (a, b) in zip(devices, shard_bounds(n, k))]
    if sum(s.shape[0] for s in shards) != n:
        raise ValueError("the shards do not hold the column")
    print("shards " + ", ".join(f"{s.device} {s.shape[0]} words" for s in shards),
          file=setup.log)
    return (lambda: lft.flagstat_sharded(shards)), shards
