"""Shared on-device MC measurement protocol — single source of truth.

The throughput protocol of bench.py and every benchmark that claims
"identical measurement protocol": the whole sampling+evaluation loop runs
on device under one jit (`fori_loop`, per-iteration PRNG folding), one
warmup call, then the median of ``reps`` wall-clock repetitions.
"""
import time


def make_mc_chunk(eval_fn, *, n_loop: int, num_tau: int, batch: int,
                  n_roots: int, dtype, iters: int, beta: float = 0.5):
    """Jitted ``mc_chunk(key) -> root sums [R]`` over ``iters`` batches of
    ``batch`` samples: sampling, ``eval_fn(varK, varT) -> roots[R, batch]``
    and accumulation, all inside one ``fori_loop`` on the device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def mc_chunk(key):
        def body(i, acc):
            # named scopes let benchmarks/profile_pass.py attribute phases
            with jax.named_scope("prng"):
                k1, k2 = jax.random.split(jax.random.fold_in(key, i))
                vk = jax.random.normal(k1, (3, n_loop, batch), dtype)
                vt = jax.random.uniform(k2, (num_tau, batch), dtype) * beta
            r = eval_fn(vk, vt)
            with jax.named_scope("accum"):
                return acc + jnp.sum(r, axis=1)

        return jax.lax.fori_loop(0, iters, body,
                                 jnp.zeros((n_roots,), dtype))

    return mc_chunk


def time_mc_chunk(mc_chunk, *, batch: int, iters: int, reps: int = 3) -> float:
    """samples/s of a warmed-up ``mc_chunk``: median of ``reps`` runs."""
    import jax

    times = []
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(mc_chunk(jax.random.PRNGKey(r)))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    return batch * iters / dt


def mc_samples_per_s(eval_fn, *, n_loop: int, num_tau: int, batch: int,
                     n_roots: int, dtype, iters: int = 200, reps: int = 3,
                     beta: float = 0.5) -> float:
    """Measure samples/s of ``eval_fn(varK, varT) -> roots[R, batch]``."""
    import jax

    mc_chunk = make_mc_chunk(eval_fn, n_loop=n_loop, num_tau=num_tau,
                             batch=batch, n_roots=n_roots, dtype=dtype,
                             iters=iters, beta=beta)
    jax.block_until_ready(mc_chunk(jax.random.PRNGKey(0)))  # compile+warmup
    return time_mc_chunk(mc_chunk, batch=batch, iters=iters, reps=reps)
