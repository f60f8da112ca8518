# Convenience targets (the reference ships a PETSc makefile,
# makefile_ref:15-27; here the "build" is the native IO codec and the
# Python package).

.PHONY: all test bench run native clean myclean golden-gate

# regression gate: compare a default-config run's history.npz
# (WORKDIR=...) against the float64 golden trajectory; a float32 run
# strays up to ~1.3e-3 from it (docs/GOLDEN_RUN.md); non-zero exit on
# breach
WORKDIR ?= .
GOLDEN ?= docs/golden_history_65x33x33.npz
RTOL ?= 2.5e-3
golden-gate:
	python tools/compare_history.py $(GOLDEN) $(WORKDIR)/history.npz $(RTOL)

all: native

native:
	python -c "from topopt_in_petsc_tpu.io import native; assert native._build_and_load() is not None, 'codec build failed'; print('native codec ready')"

test:
	python -m pytest tests/ -x -q

bench:
	python bench.py

run:
	python -m topopt_in_petsc_tpu

# mirror of the reference's `make myclean` (makefile_ref:24-27)
myclean:
	rm -f output_* Restart* RestartSol* *.vtu

clean: myclean
	rm -rf .jax_cache __pycache__ topopt_in_petsc_tpu/io/native/*.so
