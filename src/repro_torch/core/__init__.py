"""Oracles, theory constants, device resolution and stateless RNG."""
