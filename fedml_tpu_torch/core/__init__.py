"""Tree math, sampling, the non-finite screen and device selection."""
