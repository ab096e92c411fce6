"""The benchmark of the PyTorch port (`navierstokes_project_nm4pde_tpu_torch`).

`python -m nsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once; see README.md.  Nothing here imports
JAX or the JAX package.
"""
