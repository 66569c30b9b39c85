"""The reference's experiment protocols (layer L5, orchestration and
verification), each a module with a main(argv) that runs as
`python -m cuda_selection_criteria_tpu_torch.experiments.<name>`:

  compare_engines      - the device engine against the scalar host engine
                         at tau=0.01, pair by pair (comparacion_*.csv)
  run_time_experiment  - the timing sweep over SMH sizes and blocks, a
                         device arm and a host arm
                         (experimento_smh_comparativo.csv)
  confirm_throughput   - pairs/s of the exact confirm stage, host and
                         device-assisted, and the reject-bound workload
                         (one JSON line)

and the at-scale validation harnesses:

  validate_131k_scale  - the screened cascade stage by stage on the planted
                         bench bank (N=131,072 by default: 2 GiB of
                         registers; one JSON line of walls and memory)
  validate_ring_scale  - the ring engine on the same bank
  validate_screened    - smh_a (any criterion) on a planted-cluster bank
                         built by the device build ops, exactly equal to
                         the scalar host reference
  validate_hllaux      - hll_a and hll_an on its aux-HLL twin (K2)
  validate_cli_scale   - the selection CLI in a fresh interpreter on the
                         sketch files of N real-sized genomes (596,859 by
                         default: GTDB R220), every line held to the exact
                         host cascade (one JSON record)
  confirm_thread_sweep - the host confirm loop's pairs/s against threads
                         (confirm_threads.csv)

and the reference bench's protocol:

  bench                - headline (the screened chunk function) and raw
                         (K2 at p=14) pairs/s over the full triangle of
                         the N=16384 bench bank, against the card's own
                         baseline (one JSON line)
  scale_sweep          - the bench's rates at several N
  kernel_tuning        - K2's rate a tile size and launch width

and the host's allocator:

  hostmem_split        - first-touch page faults of the host stages with
                         utils/hostmem's arena reuse off and on, each
                         stage in a fresh process

Ports of experiments/{compare_engines,run_time_experiment,
confirm_throughput,validate_131k_scale,validate_ring_scale,
validate_screened_tpu,validate_hllaux_tpu,confirm_thread_sweep,
scale_sweep,kernel_tuning}.py and bench.py of the JAX package; they
default to --device cuda.
"""
