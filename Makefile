# Convenience targets (analogue of the reference's hack/common.mk surface).

PY ?= python

.PHONY: test lint cover sweep bench bench-configs profile torture native clean

test: lint
	$(PY) -m pytest tests/ -x -q

# Static checks (stdlib-ast linter; the golangci-lint role of the
# reference's CI, hack/common.mk:95-110).
lint:
	$(PY) hack/lint.py

# Line coverage over the full suite with a threshold gate (sys.monitoring;
# the coverage role of the reference's CI, hack/common.mk:372-381).
cover:
	$(PY) hack/cov.py --min 80

# Full 56-config differential sweep of the device pipeline (slow).
sweep:
	$(PY) hack/sweep_jax.py

# Headline benchmark (needs a GPU; prints one JSON line on stdout).
bench:
	$(PY) bench.py

# The five BASELINE.json benchmark configs.
bench-configs:
	$(PY) hack/bench_configs.py

profile:
	$(PY) hack/profile.py

# Randomized encoder<->decoder torture sweep (CPU; minutes).
torture:
	$(PY) hack/torture.py --iters 200

# File-level conformance campaign (random whole M4A/CAF files).
campaign:
	$(PY) hack/campaign.py --files 100

# Force-rebuild the native core.
native:
	rm -f saprobe_alac_tpu/native/_alac_core.so
	$(PY) -c "from saprobe_alac_tpu import native; assert native.available(), native.build_error()"

clean:
	rm -rf saprobe_alac_tpu/native/_alac_core.so .bench_cache/__pycache__ \
	       $(shell find . -name __pycache__ -not -path './.git/*')
