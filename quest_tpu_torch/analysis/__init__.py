"""Static and runtime checks of the port (the JAX package's
``analysis/``): ``contracts_check`` verifies every ``@sharded_contract``
against the exchange calls its canonical dispatch makes."""
