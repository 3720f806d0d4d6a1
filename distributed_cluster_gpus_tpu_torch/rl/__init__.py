"""The chsac_af agent's acting half: networks, policy, replay and the loop."""
