"""The benchmark of the PyTorch/CUDA port (`actor_critic_tpu_torch`) on one
H100: `python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` from the checkout's root. See `core.py` for what a run
does and `check.py` for what decides `correct`."""
