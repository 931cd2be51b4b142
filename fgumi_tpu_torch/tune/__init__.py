"""Self-tuning deployment profiles (the JAX package's ``tune/``).

The offline autotuner (:mod:`.autotune`, surfaced as ``tune``) sweeps a
simulated workload matrix across the wire kernel and the native f64 host
engine, records a crossover atlas, and derives a schema-versioned
:mod:`deployment profile <.profile>` of measured knob values and
router/chooser priors; the CLI and the serve daemon load it at start
(``--profile`` / ``FGUMI_TPU_PROFILE``). Profiles change scheduling only,
never the bytes written.
"""

from .profile import (PROFILE_SCHEMA_VERSION, ProfileError,  # noqa: F401
                      fingerprint_host, load_profile, validate_profile,
                      write_profile)
