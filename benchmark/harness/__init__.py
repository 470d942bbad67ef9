"""The benchmark's harness: finding cells, configurations and metric
readers by name (`spec`), the traffic (`traffic`), the weights (`weights`),
the entries that set up, time and check a cell (`entries`), the trace's
reduction (`trace`), the yardstick's arithmetic (`peaks`, `bounds`), the
comparison's readings (`compare`) and the import guard (`guard`).

Nothing here imports the JAX package; the program under test is
`animals3d_tpu_torch`, the reference is `refmodel` (beside this package).
"""
