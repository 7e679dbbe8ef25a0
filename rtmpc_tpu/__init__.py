"""rtmpc_tpu — accelerator-native robust tube-based tracking MPC over lossy networks.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
EricssonResearch/Robust-Tracking-MPC-over-Lossy-Networks (Umsonst & Barbosa,
"Remote Tube-based MPC for Tracking Over Lossy Networks", IEEE CDC 2024).

Architecture (two-phase, see SURVEY.md §7):

* **Setup phase** (host, float64 NumPy): polytope computations (support
  functions, Minkowski sums, Pontryagin differences, mRPI approximations,
  maximal admissible sets), LQR/Lyapunov gain synthesis, and condensed-QP
  matrix assembly. Produces a frozen, static-shape ``ControllerSpec`` pytree.
* **Rollout phase** (device, jit/scan/vmap/shard_map): thousands of
  closed-loop lossy-network rollouts run as one batched GPU computation.
  The per-step tracking QP is solved by a batched OSQP-style ADMM solver
  (pure JAX, or one fused Pallas kernel for the GPU); the plant/actuator/estimator protocol
  state machines are branchless pytree step functions; the lossy channel is a
  pre-drawn Bernoulli mask tensor, never actual communication.

Subpackages
-----------
utils     : polytope toolbox, discrete-time synthesis (dlqr/dlyap/c2d),
            high-accuracy host QP solver (interior point, float64).
sets      : invariant-set algorithms (Rakovic mRPI, Darup RPI, Gilbert–Tan
            maximal admissible set), constraint tightening.
ops       : canonical box-constrained QP struct, batched ADMM solver
            (JAX + a Pallas/Triton kernel), condensed QP assembly for all
            controller variants.
models    : controller specs (setup -> frozen pytree) and plants (linear,
            analytic cartpole with ZOH).
protocol  : smart/consistent actuator + (robust) estimator state machines,
            packet/consistency logic, loss-mask generation.
parallel  : lax.scan rollout engine, vmap batching, device-mesh sharding,
            Monte-Carlo sweep drivers, metrics.
apps      : runnable equivalents of the reference's example & results scripts.
"""

__version__ = "0.1.0"
