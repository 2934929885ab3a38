"""Test-support machinery that ships with the port (ports
paddle_tpu/testing/): ``failpoints``, the registered fault-injection
framework, ``parity``, the lockstep A/B loss-parity harness over the
numerics telescope, and the shared inputs of the port's cross-checks
(``golden``: the narrow GPT whose JAX outputs are committed as a
fixture)."""
