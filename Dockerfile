# stoat-tpu container — parity with the reference's Dockerfile
# (/root/reference/Dockerfile: Ubuntu 22.04 + build deps + vg binary),
# adapted to this stack: python + jax + a C++17 toolchain for the
# auto-compiled native cores (VCF ingest, snarl decomposition, baseline).
# On an NVIDIA GPU host, install the CUDA plugin of the installed JAX
# (pip install "jax[cuda12]") and run with --gpus all.
FROM ubuntu:22.04

ENV DEBIAN_FRONTEND=noninteractive

RUN apt-get update && apt-get install -y \
    build-essential \
    g++ \
    zlib1g-dev \
    python3 \
    python3-pip \
    python3-venv \
    wget \
    && rm -rf /var/lib/apt/lists/*

# vg: used to build graphs/distance indexes upstream of stoat
# (same binary release the reference installs, Dockerfile:24-27)
WORKDIR /bin
RUN wget -q https://github.com/vgteam/vg/releases/download/v1.67.0/vg \
    && chmod +x vg || echo "vg download skipped (offline build)"

WORKDIR /stoat
COPY . /stoat

RUN python3 -m venv /opt/stoat-venv \
    && /opt/stoat-venv/bin/pip install --upgrade pip \
    && /opt/stoat-venv/bin/pip install . pytest

# vg-in-the-loop integration tests (image-gated; skip without vg):
#   docker run --entrypoint pytest <image> \
#       /stoat/tests/test_vg_integration.py -v
# With a reference stoat build mounted, add -e STOAT_BIN=/path/to/stoat
# to also diff both tools' outputs on identical vg-built inputs.

ENV PATH=/opt/stoat-venv/bin:$PATH

# pre-build the native cores so first run doesn't pay the compile
RUN python -c "import stoat_tpu.native as n; n.get_lib(); \
               n.get_graph_lib(); n.get_baseline_lib()" || true

WORKDIR /home
ENTRYPOINT ["stoat"]
CMD ["version"]
