"""Loop closure: BoW place recognition and geometric verification."""
