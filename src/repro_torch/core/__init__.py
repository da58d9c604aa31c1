"""Core library: step-size policies, prox operators, problems, the event
engine and PIAG (counterparts of ``repro.core`` modules of the same name)."""
