"""On the card, at the cells' own size (``python3 -m pytest cardbench/tests
-m card -s``): the control reads not correct on three seeds, and a short
run of each cell reads correct. Each skips without a card."""
import json

import pytest

from cardbench import control, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CONTROL_SEEDS = {"lz4-stream": [3_100_000_011, 3_100_000_012, 3_100_000_013],
                 "column-device": [3_100_000_021, 3_100_000_022, 3_100_000_023],
                 "column-blocks": [3_100_000_031, 3_100_000_032, 3_100_000_033]}


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_not_correct_at_the_cells_size(workload, card, capsys):
    seeds = [str(s) for s in CONTROL_SEEDS[workload]]
    assert control.main(["--workload", workload, "--seeds", *seeds]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    with capsys.disabled():
        for line in lines:
            print(json.dumps(line))
    assert len(lines) == 3 and not any(x["correct"] for x in lines)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_of_each_cell_reads_correct(workload, card):
    out = run.run(workload, 3_100_000_100 + CELLS.index(workload), 2.0, False)
    assert out["correct"] is True and out["attempted"] >= 1
