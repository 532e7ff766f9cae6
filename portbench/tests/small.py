"""Cells cut to a size the CPU runs in seconds, for the tests: the same
code paths, with the port's plain versions in place of its kernels."""

from __future__ import annotations

import copy

from portbench import spec


def small_cell(name: str = "local_100k.ingest") -> spec.Cell:
    cell = spec.load_cell(name)
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    config["keys"] = {"counter": 400, "gauge": 200, "timer": 300,
                      "set": 100}
    config["server"]["tpu"] = {
        "counter_capacity": 512, "gauge_capacity": 256,
        "histo_capacity": 512, "set_capacity": 128, "batch_cap": 1024,
        "set_promote_samples": 16}
    config["server"]["interval"] = "2s"
    traffic.update({"pool_batches": 8, "datagrams_per_batch": 32})
    traffic["family_share"] = {"counter": 0.1, "gauge": 0.1,
                               "timer": 0.5, "set": 0.3}
    cell.config, cell.traffic = config, traffic
    return cell
