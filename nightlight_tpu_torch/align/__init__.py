"""Star alignment: triangle matching with a closed-form affine refine."""
