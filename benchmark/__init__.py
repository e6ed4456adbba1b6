"""The benchmark of sddm_tpu_torch, the PyTorch and CUDA port: one command
runs one cell of ``BENCHMARK.json`` once (``python3 -m benchmark.run
--workload <name> --seed <n> --seconds <s> --trace <0|1>``)."""
