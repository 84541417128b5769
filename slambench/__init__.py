"""The benchmark of the PyTorch and CUDA port `orb_slam2_tpu_torch`: run one
cell once with `python3 slambench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
