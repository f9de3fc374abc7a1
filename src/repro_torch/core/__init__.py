"""Model, compile, propagation, search and the solver API of the port."""
