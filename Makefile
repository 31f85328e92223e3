# Mirrors the reference's Makefile targets (build/test/perf/trace) for the
# TPU-native framework. `make trace` is the analogue of the reference's
# `make mactrace` (dotnet-trace -> speedscope): it writes a jax.profiler
# trace viewable in TensorBoard/XProf.

PYTHON ?= python

.PHONY: test perf trace perf-torch trace-torch sharded-torch lint

test:
	$(PYTHON) -m pytest tests/ -q

perf:
	$(PYTHON) bench.py

trace:
	$(PYTHON) bench.py --profile /tmp/sdfkit_tpu_trace
	@echo "trace written; view with: tensorboard --logdir /tmp/sdfkit_tpu_trace"

# The PyTorch/CUDA port on a CUDA card (bench_torch.py refuses to run without
# one): the same sections as `perf`, and a torch.profiler Chrome trace.
perf-torch:
	$(PYTHON) bench_torch.py

trace-torch:
	$(PYTHON) bench_torch.py --profile /tmp/sdfkit_tpu_torch_trace
	@echo "trace written; open /tmp/sdfkit_tpu_torch_trace/trace.json.gz in Perfetto or chrome://tracing"

# The port's sharded paths over NCCL on a machine of several cards, a card
# for each of RANKS ranks (refused with fewer cards than ranks).
RANKS ?= 4

sharded-torch:
	$(PYTHON) tools/torch_distributed_demo.py --ranks $(RANKS) --size cards --backend nccl

lint:
	$(PYTHON) -m compileall -q sdfkit_tpu sdfkit_tpu_torch tests bench.py bench_torch.py __graft_entry__.py
