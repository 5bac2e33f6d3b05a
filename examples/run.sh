#!/bin/bash
# Demo-run driver: the workflow equivalent of the reference's run.sh
# (/root/reference/run.sh), which sed-edits compile-time lattice dims into
# CMakeLists.txt, rebuilds the executable, and pipes 10 parameters into
# `mpirun -n RANKS SM_NxxNt`. Here there is nothing to rebuild — lattice
# dims are runtime flags — and the same 10 parameters go in the same order
# through the same stdin pipe, so existing parameter files keep working.
#
# Run from anywhere:  bash examples/run.sh
set -euo pipefail
cd "$(dirname "$0")/.."

NX=${NX:-64}            # lattice dimensions (runtime — no rebuild per size)
NT=${NT:-64}
RANKS_X=1        # device-mesh shape; ranks_x*ranks_t must be <= jax.device_count()
RANKS_T=1        #   (on a single device use 1 1; sharding needs a multi-device mesh)
M0=0.2           # bare mass
BETA=4           # coupling
MD_STEPS=10      # molecular-dynamics steps
TAU=0.1          # trajectory length
NTHERM=${NTHERM:-10}        # thermalization trajectories
NMEAS=${NMEAS:-10}         # measurements
NSTEPS=${NSTEPS:-10}        # decorrelation trajectories between measurements
SAVE=${SAVE:-1}           # 0 do not save confs, 1 save confs (binary .ctxt, reference format)

OUT_DIR=${OUT_DIR:-.}

printf "${RANKS_X}\n${RANKS_T}\n${M0}\n${MD_STEPS}\n${TAU}\n${BETA}\n${NTHERM}\n${NMEAS}\n${NSTEPS}\n${SAVE}\n" \
  | python -m schwingermodel_tpu --nx "${NX}" --nt "${NT}" --out-dir "${OUT_DIR}"
