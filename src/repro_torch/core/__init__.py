"""The paper's algorithms on the operator protocol (Alg 1–3)."""
