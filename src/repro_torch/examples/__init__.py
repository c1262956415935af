"""The reference's seven example scripts on the port, one module each:

    python -m repro_torch.examples.<name> [--device cuda] [...]

``mpklink_demo`` (the §V lifecycle, the transport comparison, the threat
model, the guard kernel), ``gateway_demo`` (services, concurrent clients,
the ACL, a forged frame, revocation), ``chaos_demo`` (a seeded fault storm,
its replay, a healing client, the circuit breaker), ``quickstart`` (an
MPKLink round trip, then a tiny llama trained and decoded),
``serve_decode`` (a burst through the serving engine), ``train_e2e`` (the
trainer with an injected failure and a restart from its checkpoint) and
``fabric_parallel_demo`` (SP, EP, PP and DP over four gloo ranks, each
against its one-rank oracle).

Each has a ``main(argv=None)``; ``--device`` defaults to ``cuda`` (the
kernels run on the card), and ``--device cpu`` runs the plain versions.
Every printed check raises when it fails. The sizes are the reference's:
demos on reduced configurations."""
