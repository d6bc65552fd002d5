# Container environment for ascendpathtracing (the analogue of the
# reference's CANN container, Dockerfile:1-43 — here the "toolkit" is a
# JAX wheel set).
#
# CPU-only development/test image; on a GPU machine install the matching
# `jax[cuda12]` wheel instead of `jax[cpu]`.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    build-essential make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/ascendpathtracing
COPY pyproject.toml README.md ./
COPY ascendpathtracing ./ascendpathtracing
COPY tests ./tests
COPY bench.py __graft_entry__.py ./

RUN pip install --no-cache-dir "jax[cpu]" numpy pytest && \
    pip install --no-cache-dir -e . && \
    make -C ascendpathtracing/native

# smoke: render the reference config end-to-end
RUN python -m ascendpathtracing.cli render --backend cpu --out /tmp/smoke

CMD ["python", "-m", "pytest", "tests/", "-q"]
