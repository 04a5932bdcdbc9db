import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def make_batch(cfg, B, S, key, with_users=0):
    kt, kl, ke, ku = jax.random.split(key, 4)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if cfg.embed_input:
        batch = {"embeds": jax.random.normal(ke, (B, S, cfg.d_model), jnp.float32),
                 "labels": jax.random.randint(kl, (B, S), 0, cfg.vocab_size)}
    else:
        batch = {"tokens": jax.random.randint(kt, (B, S) + cb, 0, cfg.vocab_size),
                 "labels": jax.random.randint(kl, (B, S) + cb, 0, cfg.vocab_size)}
    if with_users:
        batch["user_id"] = jax.random.randint(ku, (B,), 0, with_users)
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")
